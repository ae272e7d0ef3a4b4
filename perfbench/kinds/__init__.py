"""One module a model kind, named by a configuration's ``kind``: its
data made from the seed, its plain reference, its operation count and
the unit of work a request does. Plain PyTorch: nothing here imports
the program under test."""
