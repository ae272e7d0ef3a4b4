#!/usr/bin/env python3
"""Time the port's CUDA kernels from two source trees in turns, on one card.

Run from the repository root:  python3 kernel_ab.py OTHER_CSRC

OTHER_CSRC is another tree's ``netsdb_tpu_torch/csrc``, for instance the
parent commit's, unpacked with ``git archive`` into a git-ignored
directory. Three variants of B1 (``flash_attention.cu``) and B2
(``flash_attention_step.cu``) are built with the port's nvcc flags into
``netsdb_tpu_torch/_build/ab/``:

- ``this``: this tree's sources;
- ``other``: OTHER_CSRC's sources;
- ``inlined``: this tree's sources with each ``#include "*.cuh"``
  replaced by the header's text, so a shared header can be held against
  the same fold written into each source.

Each case runs the variants in turns (this, other, inlined, inlined,
other, this), after checking each against the plain PyTorch version:
B1 at the transformer path's shape (2, 8, 4096, 128), causal, in f32 and
bf16, and B2 as the ring's chained fold (bh 16, four chunks of 4096,
D 128, q at the last position), causal, in f32 and bf16. It prints one
JSON line per case and the card's name and power limit, and exits
non-zero without a card or if a variant fails to build or disagrees.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNELS = ("flash_attention", "flash_attention_step")
ORDER = ("this", "other", "inlined", "inlined", "other", "this")


def inline_headers(src: Path) -> str:
    """``src``'s text with each ``#include "x.cuh"`` replaced by x.cuh."""
    return re.sub(r'#include "(\w+\.cuh)"',
                  lambda m: (src.parent / m.group(1)).read_text(),
                  src.read_text())


def build_variants(other: Path) -> dict:
    """{(variant, kernel): built library path}, one nvcc each, in parallel."""
    from netsdb_tpu_torch.ops import cuda_build

    out = cuda_build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name in KERNELS:
        sources["this", name] = cuda_build.SRC_DIR / f"{name}.cu"
        sources["other", name] = other / f"{name}.cu"
        inlined = out / f"{name}_inlined.cu"
        inlined.write_text(inline_headers(cuda_build.SRC_DIR / f"{name}.cu"))
        sources["inlined", name] = inlined

    def build(key):
        lib = out / f"lib{key[1]}_{key[0]}.so"
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                               "-o", str(lib), str(sources[key])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{proc.stdout}"
                               f"{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill stores" in line:
                print(f"[ab-build] {key[0]} {key[1]}: {line.strip()}")
        return lib

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def entry(lib: Path, name: str):
    from netsdb_tpu_torch.ops.cuda_kernels import _ENTRY

    symbol, argtypes = _ENTRY[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import (BF16_TOL, F32_TOL, SEED, fold_chain, nvidia_smi,
                            time_ms)
    from netsdb_tpu_torch.ops.cuda_kernels import (_LOG2E,
                                                   flash_attention_plain,
                                                   flash_attention_step_plain)

    smi = nvidia_smi()
    libs = build_variants(Path(sys.argv[1]))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = torch.cuda.current_stream().cuda_stream

    def b1(variant, q, k, v):
        fn = entry(libs[variant, "flash_attention"], "flash_attention")
        b, h, s, d = q.shape
        out = torch.empty_like(q)

        def run():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b * h, s, d, d ** -0.5 * _LOG2E, 1,
                    int(q.dtype == torch.bfloat16), stream)
            if rc:
                raise RuntimeError(f"{variant} B1 launch failed ({rc})")
            return out
        return run

    def b2(variant, q, chunks):
        fn = entry(libs[variant, "flash_attention_step"],
                   "flash_attention_step")

        def step(q, k, v, acc, l, m, q_off, k_off, causal):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                    l.data_ptr(), m.data_ptr(), q.shape[0], q.shape[1],
                    k.shape[1], q.shape[2], q.shape[2] ** -0.5 * _LOG2E,
                    q_off, k_off, int(causal),
                    int(q.dtype == torch.bfloat16), stream)
            if rc:
                raise RuntimeError(f"{variant} B2 launch failed ({rc})")
            return acc, l, m
        return lambda: fold_chain(step, q, chunks, True)[0]

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((2, 8, 4096, 128), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        cases.append((f"B1 {dtype}", lambda var, q=q, k=k, v=v: b1(var, q, k, v),
                      flash_attention_plain(q, k, v, True)))
    for dtype in (torch.float32, torch.bfloat16):
        bh, s, n = 16, 4096, 4
        q = torch.randn((bh, s, 128), generator=gen, device="cuda").to(dtype)
        chunks = [(torch.randn((bh, s, 128), generator=gen,
                               device="cuda").to(dtype),
                   torch.randn((bh, s, 128), generator=gen,
                               device="cuda").to(dtype), (n - 1) * s, i * s)
                  for i in range(n)]
        cases.append((f"B2 chain {dtype}",
                      lambda var, q=q, chunks=chunks: b2(var, q, chunks),
                      fold_chain(flash_attention_step_plain, q, chunks,
                                 True)[0]))

    for label, make, ref in cases:
        runs = {var: make(var) for var in dict.fromkeys(ORDER)}
        tol = BF16_TOL if ref.dtype == torch.bfloat16 else F32_TOL
        errs = {}
        for var, run in runs.items():
            out = run()
            torch.cuda.synchronize()
            errs[var] = (out.float() - ref.float()).abs().max().item()
            if not errs[var] <= tol:
                raise RuntimeError(f"{label} {var}: max abs err {errs[var]}")
        ms = {var: [] for var in runs}
        for var in ORDER:
            ms[var].append(time_ms(runs[var], iters=10 if "B1" in label
                                   else 3))
        print(json.dumps({"case": label, "ms": ms, "max_abs_err": errs,
                          "card": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
