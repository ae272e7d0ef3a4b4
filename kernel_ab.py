#!/usr/bin/env python3
"""Time the port's CUDA kernels from two source trees in turns, on one card.

Run from the repository root:  python3 kernel_ab.py OTHER_CSRC
                          or:  python3 kernel_ab.py --tf32-chain 1,2,4,8,16

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

Each variant is called with its own entry points' arguments: the
``mma.sync`` fold's (no scratch) or the ``wgmma`` fold's (float32's split
scratch and the row pitches), told apart by the source. Each case runs
the variants in turns (this, other, inlined, inlined, other, this),
after checking each against the plain PyTorch version: B1 at the
transformer path's shape (2, 8, 4096, 128), causal, in f32 and bf16, and
B2 as the ring's chained fold (bh 16, four chunks of 4096, D 128, q at
the last position), causal, in f32 and bf16. It prints one JSON line per
case and the card's name and power limit, and exits non-zero without a
card or if a variant fails to build or disagrees.

``--tf32-chain N,...`` builds this tree's sources, headers inlined, once
for each depth N of the float32 fold's accumulator chains (the header's
``kTf32Chain`` rewritten to N: N 8-deep steps of three passes before the
f32 add) and prints, per depth,
B1's and B2's f32 time at the same shapes and their error against the
plain version and against an f64 attention over the first two (b, h)
slices, over the plain version's error there (``chip_smoke.py`` phase 2
holds that ratio to ``F64_RATIO``).
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


def _nvcc(lib: Path, src: Path) -> Path:
    from netsdb_tpu_torch.ops import cuda_build

    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill stores" in line:
            print(f"[ab-build] {lib.stem}: {line.strip()}")
    return lib


def build_variants(other: Path) -> dict:
    """{(variant, kernel): (built library, source)}, one nvcc each, in
    parallel."""
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
        return (_nvcc(out / f"lib{key[1]}_{key[0]}.so", sources[key]),
                sources[key])

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


# the entry points' arguments under the mma.sync fold, which took no
# scratch and no row pitches
_PLAIN_ENTRY = {
    "flash_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "flash_attention_step": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


class Entry:
    """A built library's B1 or B2 entry point, called with the arguments
    its source declares."""

    def __init__(self, lib: Path, src: Path, name: str):
        from netsdb_tpu_torch.ops.cuda_kernels import _ENTRY

        symbol, argtypes = _ENTRY[name]
        self.scratch = "void* scratch" in src.read_text()
        self.fn = getattr(ctypes.CDLL(str(lib)), symbol)
        self.fn.argtypes = argtypes if self.scratch else _PLAIN_ENTRY[name]
        self.fn.restype = ctypes.c_int

    def b1(self, q, k, v, out, scratch, stream):
        import torch

        from netsdb_tpu_torch.ops.cuda_kernels import _LOG2E

        b, h, s, d = q.shape
        bf16 = int(q.dtype == torch.bfloat16)
        head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        tail = [d ** -0.5 * _LOG2E, 1, bf16, stream]
        if self.scratch:
            return self.fn(*head, scratch.data_ptr(), scratch.numel(),
                           b * h, s, d, d, d, *tail)
        return self.fn(*head, b * h, s, d, *tail)

    def b2(self, q, k, v, acc, l, m, q_off, k_off, causal, scratch, stream):
        import torch

        from netsdb_tpu_torch.ops.cuda_kernels import _LOG2E

        bh, s_q, d = q.shape
        head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                l.data_ptr(), m.data_ptr()]
        tail = [d ** -0.5 * _LOG2E, q_off, k_off, int(causal),
                int(q.dtype == torch.bfloat16), stream]
        if self.scratch:
            return self.fn(*head, scratch.data_ptr(), scratch.numel(), bh,
                           s_q, k.shape[1], d, d, d, *tail)
        return self.fn(*head, bh, s_q, k.shape[1], d, *tail)


def cases(gen):
    """[(label, dtype, make_inputs)]: B1 at the layer's shape and B2's
    chain, f32 and bf16, inputs from the seed."""
    import torch

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((2, 8, 4096, 128), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        out.append(("B1", dtype, (q, k, v)))
    for dtype in (torch.float32, torch.bfloat16):
        bh, s, n = 16, 4096, 4
        q = torch.randn((bh, s, 128), generator=gen, device="cuda").to(dtype)
        chunks = [(torch.randn((bh, s, 128), generator=gen,
                               device="cuda").to(dtype),
                   torch.randn((bh, s, 128), generator=gen,
                               device="cuda").to(dtype), (n - 1) * s, i * s)
                  for i in range(n)]
        out.append(("B2 chain", dtype, (q, chunks)))
    return out


def runner(entry: Entry, label, inputs, stream):
    """A closure that runs one case through ``entry`` and returns its
    output (B1's o, B2's finished chain)."""
    import torch

    from chip_smoke import fold_chain
    from netsdb_tpu_torch.ops.cuda_kernels import split_scratch_bytes

    if label == "B1":
        q, k, v = inputs
        out = torch.empty_like(q)
        scratch = torch.empty(split_scratch_bytes(16, 4096, 128),
                              dtype=torch.uint8, device="cuda")

        def run():
            rc = entry.b1(q, k, v, out, scratch, stream)
            if rc:
                raise RuntimeError(f"B1 launch failed ({rc})")
            return out
        return run
    q, chunks = inputs
    scratch = torch.empty(split_scratch_bytes(16, 4096, 128),
                          dtype=torch.uint8, device="cuda")

    def step(q, k, v, acc, l, m, q_off, k_off, causal):
        rc = entry.b2(q, k, v, acc, l, m, q_off, k_off, causal, scratch,
                      stream)
        if rc:
            raise RuntimeError(f"B2 launch failed ({rc})")
        return acc, l, m
    return lambda: fold_chain(step, q, chunks, True)[0]


def reference(label, inputs):
    from chip_smoke import fold_chain
    from netsdb_tpu_torch.ops.cuda_kernels import (flash_attention_plain,
                                                   flash_attention_step_plain)

    if label == "B1":
        return flash_attention_plain(*inputs, True)
    q, chunks = inputs
    return fold_chain(flash_attention_step_plain, q, chunks, True)[0]


def f64_errors(label, inputs, out, ref) -> tuple:
    """(kernel's, plain version's) max abs error against an f64 attention
    over the first two (b, h) slices."""
    import torch

    from chip_smoke import attention_f64

    if label == "B1":
        q, k, v = (t.reshape(16, 4096, 128)[:2] for t in inputs)
        pos = torch.arange(4096, device="cuda")
        exact = attention_f64(q, k, v, pos, pos, True, 128 ** -0.5)
        got, want = out.reshape(16, 4096, 128)[:2], ref.reshape(16, 4096,
                                                                 128)[:2]
    else:
        q, chunks = inputs
        k = torch.cat([c[0][:2] for c in chunks], dim=1)
        v = torch.cat([c[1][:2] for c in chunks], dim=1)
        q_pos = chunks[0][2] + torch.arange(q.shape[1], device="cuda")
        k_pos = torch.arange(k.shape[1], device="cuda")
        exact = attention_f64(q[:2], k, v, q_pos, k_pos, True, 128 ** -0.5)
        got, want = out[:2], ref[:2]
    return ((got.double() - exact).abs().max().item(),
            (want.double() - exact).abs().max().item())


def ab(other: Path, smi: str) -> None:
    import torch

    from chip_smoke import BF16_TOL, F32_TOL, SEED, time_ms

    libs = build_variants(other)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for label, dtype, inputs in cases(gen):
        name = "flash_attention" if label == "B1" else "flash_attention_step"
        runs = {var: runner(Entry(*libs[var, name], name), label, inputs,
                            stream)
                for var in dict.fromkeys(ORDER)}
        ref = reference(label, inputs)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        errs = {}
        for var, run in runs.items():
            out = run()
            torch.cuda.synchronize()
            errs[var] = (out.float() - ref.float()).abs().max().item()
            if not errs[var] <= tol:
                raise RuntimeError(f"{label} {dtype} {var}: max abs err "
                                   f"{errs[var]}")
        ms = {var: [] for var in runs}
        for var in ORDER:
            ms[var].append(time_ms(runs[var],
                                   iters=10 if label == "B1" else 3))
        print(json.dumps({"case": f"{label} {dtype}", "ms": ms,
                          "max_abs_err": errs, "card": smi}))


def chain_sweep(depths, smi: str) -> None:
    """This tree's float32 fold at each accumulator-chain depth."""
    import torch

    from chip_smoke import F32_TOL, SEED, time_ms
    from netsdb_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = [(n, name) for n in depths for name in KERNELS]

    def build(key):
        n, name = key
        src = out_dir / f"{name}_chain{n}.cu"
        text, hits = re.subn(
            r"constexpr int kTf32Chain = \d+;",
            f"constexpr int kTf32Chain = {n};",
            inline_headers(cuda_build.SRC_DIR / f"{name}.cu"))
        if hits != 1:
            raise RuntimeError(f"{name}: no kTf32Chain to rewrite")
        src.write_text(text)
        return _nvcc(out_dir / f"lib{name}_chain{n}.so", src), src

    with ThreadPoolExecutor(max_workers=len(keys)) as pool:
        libs = dict(zip(keys, pool.map(build, keys)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    f32 = [c for c in cases(gen) if c[1] == torch.float32]
    refs = {label: reference(label, inputs) for label, _, inputs in f32}
    for n in depths:
        row = {"tf32_chain": n, "card": smi}
        for label, _, inputs in f32:
            name = ("flash_attention" if label == "B1"
                    else "flash_attention_step")
            run = runner(Entry(*libs[n, name], name), label, inputs, stream)
            out = run()
            torch.cuda.synchronize()
            err = (out.float() - refs[label].float()).abs().max().item()
            if not err <= F32_TOL:
                raise RuntimeError(f"{label} chain {n}: max abs err {err}")
            e64, plain64 = f64_errors(label, inputs, out, refs[label])
            row[label] = {"ms": [time_ms(run, iters=10 if label == "B1"
                                         else 3) for _ in range(3)],
                          "max_abs_err": err, "f64_err": e64,
                          "plain_f64_err": plain64,
                          "f64_ratio": e64 / max(plain64, 1e-300)}
        print(json.dumps(row))


def main() -> int:
    import torch

    args = sys.argv[1:]
    chain = len(args) == 2 and args[0] == "--tf32-chain"
    if not (chain or len(args) == 1) or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import nvidia_smi

    smi = nvidia_smi()
    if chain:
        chain_sweep([int(n) for n in args[1].split(",")], smi)
    else:
        ab(Path(args[0]), smi)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
