"""Re-exec onto the packaged interpreter — stdlib only; the port's copy
of ``netsdb_tpu/_reexec.py``.

An image's PATH python may have an empty site-packages while the real
environment (numpy/torch) lives in a virtual environment whose
interpreter ``NETSDB_VENV_PYTHON`` names (``VENV``; unset: no
re-exec). Entry points call
:func:`maybe_reexec` from their ModuleNotFoundError handlers to replace
the process with the venv interpreter re-running the ORIGINAL command
line (recovered from ``/proc/self/cmdline``, so ``-m pkg.submodule``
targets re-run exactly as requested rather than being rewritten).

Must not import anything outside the stdlib (importing the rest of the
package would re-trigger the very ModuleNotFoundError being handled).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

VENV = os.environ.get("NETSDB_VENV_PYTHON", "")


def _original_argv() -> Optional[list]:
    """This process's full command line (linux); None if unrecoverable."""
    try:
        with open("/proc/self/cmdline", "rb") as f:
            raw = f.read()
    except OSError:
        return None
    args = [a.decode(errors="replace") for a in raw.split(b"\0") if a]
    return args or None


def maybe_reexec(flag: str,
                 require_module_prefix: Optional[str] = None) -> None:
    """Replace the process with ``VENV <original args>``.

    No-ops (returning so the caller can re-raise its import error) when
    the venv is missing, the loop-guard env ``flag`` is already set, the
    original command line cannot be recovered, or
    ``require_module_prefix`` is given and the command was not
    ``python -m <prefix>[...]`` — a plain ``import netsdb_tpu_torch`` from
    some unrelated broken interpreter must fail normally, not have its
    process hijacked.
    """
    if not VENV or not os.path.exists(VENV) or os.environ.get(flag):
        return
    args = _original_argv()
    if args is None:
        return
    if require_module_prefix is not None:
        # "-m" must be the interpreter's own option (directly after
        # argv[0]) — scanning the whole line would let a SCRIPT's
        # "-m netsdb_tpu_torch" argument hijack `python my_tool.py -m
        # netsdb_tpu_torch` into a re-exec. Interpreter flags before -m are
        # rare here; if present we conservatively decline.
        if len(args) < 3 or args[1] != "-m":
            return
        mod = args[2]
        if mod != require_module_prefix and not mod.startswith(
                require_module_prefix + "."):
            return
    os.environ[flag] = "1"
    os.execv(VENV, [VENV] + args[1:])
