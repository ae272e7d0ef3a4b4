import sys

try:
    from netsdb_tpu_torch.cli import main
except ModuleNotFoundError:  # pragma: no cover
    # a partially broken environment discovered in the CLI's own
    # imports: re-run the original command line on the packaged
    # interpreter, if there is one
    from netsdb_tpu_torch import _reexec

    _reexec.maybe_reexec("NETSDB_CLI_REEXEC",
                         require_module_prefix="netsdb_tpu_torch")
    raise

if __name__ == "__main__":  # importing the module runs nothing
    sys.exit(main())
