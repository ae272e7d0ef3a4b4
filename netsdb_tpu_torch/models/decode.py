"""Session-serving decode workloads — the port's ``netsdb_tpu/models/
decode.py``: batched autoregressive steps over the state of many
sessions.

The stateful-serving path (``serve/sessions.py``) keeps each session's
recurrent or KV state on the device between requests, and every
``GENERATE`` advances it by one step. Two disciplines hold:

* **One step program per (kind, shape signature, bucket).** Concurrent
  steps of one model coalesce into one padded batch whose size lands on
  the ``plan/staging.bucket_rows`` ladder (floor 8), so batch churn
  between 1 and ``decode_batch_max`` live sessions reuses one program.
  On the card the program is a CUDA graph with static input and output
  buffers, captured once; on the CPU it is the eager function.
  :func:`decode_stats`'s ``traces`` counts captures on the card and
  first builds on the CPU — the trace-pinning gates read it.
* **O(1) per-step state.** The LSTM carries ``(h, c)``; the transformer
  layer a ring-buffer KV cache of ``kv_max`` entries written at
  ``pos % kv_max``.

Every step function is row-independent: row ``i`` of the output depends
only on row ``i`` of the inputs and the shared weights, and a solo
session pads to the same bucket, so at ``decode_batch_max = 8`` a session
decoded inside a batch is bit-equal to the same session decoded alone
(same shapes, same kernels, same graph).

State stays on the device: a batch is stacked and split with
``torch.stack`` and indexing on the state's device (the reference
stacks through numpy, a device→host→device copy of every KV cache on
every step). :meth:`DecodeRuntime.step_batch` returns new states on the
device and outputs on the host, as the reference's does.

**Multi-model residency** (``config.model_dedup``): each registered
model's weight pages are fingerprinted with ``dedup.detector``; once two
models are registered the sets pool through ``Client.dedup_resident``,
and :meth:`DecodeRuntime.residency_report` splits every shared page's
bytes across its referents, so the charges sum to the pool."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.dedup import detector as _detector
from netsdb_tpu_torch.plan import programs as plan_programs
from netsdb_tpu_torch.plan.staging import bucket_rows
from netsdb_tpu_torch.utils.locks import TrackedLock

#: decode model kinds the runtime drives
DECODE_KINDS = ("lstm", "transformer_layer")

#: weight set names per kind — one store set per tensor, so the dedup
#: detector sees every fine-tuned variant's pages as ordinary blocks
LSTM_WEIGHTS = ("w_i", "w_f", "w_c", "w_o",
                "u_i", "u_f", "u_c", "u_o",
                "b_i", "b_f", "b_c", "b_o")
TRANSFORMER_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")

# process-global step programs keyed (kind, shape signature, bucket),
# and the monotonic counters the trace-pinning gates read
_programs: Dict[Tuple, "_StepProgram"] = {}
_stats = {"traces": 0, "programs": 0, "batches": 0, "steps": 0,
          "pad_rows": 0}
_mu = threading.Lock()


def decode_stats() -> Dict[str, int]:
    """Snapshot of the step-program cache — ``traces`` counts captures
    (card) and first builds (CPU), ``batches``/``steps``/``pad_rows``
    the coalescing efficiency."""
    with _mu:
        out = dict(_stats)
        out["programs"] = len(_programs)
    return out


def clear_decode_programs() -> None:
    """Drop every cached step program and zero the counters."""
    with _mu:
        _programs.clear()
        for k in _stats:
            _stats[k] = 0


obs.REGISTRY.register_collector("decode", decode_stats)


def decode_bucket(n: int) -> int:
    """The padded batch size for ``n`` concurrent sessions — the
    ``bucket_rows`` ladder (floor 8), so 1..8 live sessions share one
    program."""
    return bucket_rows(int(n))


class _StepGraph:
    """A captured step: the graph, its static weights, inputs and
    outputs, and the weights dict whose values the static weights hold."""

    def __init__(self, graph, params, statics, args, outs):
        self.graph = graph
        self.params = params
        self.statics = statics
        self.args = args
        self.outs = outs


class _StepProgram:
    """One step program. On the CPU the eager function. On the card a
    CUDA graph captured on the first call over static input buffers; a
    call copies its inputs into them, replays, and clones the outputs.
    The weights are static inputs too, refreshed when the caller passes
    another weights dict than the one they were copied from (one graph
    serves every model of the shape); the program keeps that dict, so
    its tensors' addresses cannot pass to another model while it stands.
    Calls serialize on the program's lock: the static buffers are
    shared. The capture runs under ``plan/programs``' build lock and its
    pool counts in the same budget as the plans' graphs, which may drop
    it (the next call captures again)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.lock = threading.Lock()
        self._eager = False
        self._g: Optional[_StepGraph] = None

    def __call__(self, params: Dict[str, torch.Tensor],
                 *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        device = args[0].device
        if device.type != "cuda":
            with self.lock:
                if not self._eager:
                    self._eager = True
                    with _mu:
                        _stats["traces"] += 1
            return self.fn(params, *args)
        captured = None
        with self.lock:
            g = self._g
            if g is None:
                with _mu:
                    _stats["traces"] += 1
                g, captured = self._capture(params, args)
                self._g = g
            elif g.params is not params:
                for k, src in params.items():
                    g.statics[k].copy_(src)
                g.params = params
            for static, src in zip(g.args, args):
                static.copy_(src)
            g.graph.replay()
            outs = tuple(o.clone() for o in g.outs)
        if captured is not None:
            plan_programs._pool_add(self, "step", captured)
        else:
            plan_programs._pool_touch(self, "step")
        return outs

    def drop(self, sig) -> None:
        """The graph pool's budget dropped this graph: a call in flight
        keeps its own reference, the next call captures again."""
        self._g = None

    def _capture(self, params, args) -> Tuple[_StepGraph, int]:
        dev = args[0].device
        with plan_programs._build_lock:
            statics = {k: v.clone() for k, v in params.items()}
            static_args = [a.clone() for a in args]
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):  # warm up the kernels' workspaces
                self.fn(statics, *static_args)
            torch.cuda.current_stream(dev).wait_stream(side)
            mem0 = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = tuple(self.fn(statics, *static_args))
            nbytes = torch.cuda.memory_reserved(dev) - mem0
        return (_StepGraph(graph, params, statics, static_args, outs),
                max(int(nbytes), 0))


def _program(key: Tuple, build: Callable) -> _StepProgram:
    """The step program for ``key``, built at most once per key for the
    process lifetime."""
    with _mu:
        prog = _programs.get(key)
        if prog is None:
            prog = _programs[key] = _StepProgram(build)
    return prog


# --- step functions (row-independent by construction) -----------------

def _lstm_step(params, h, c, x):
    """One batched LSTM cell step: ``(B, hidden)`` state and ``(B, in)``
    input → ``(h', c')`` (``w``: hidden×in, ``u``: hidden×hidden, ``b``:
    hidden)."""
    def gate(name):
        return (x @ params["w_" + name].T + h @ params["u_" + name].T
                + params["b_" + name])

    i = torch.sigmoid(gate("i"))
    f = torch.sigmoid(gate("f"))
    g = torch.tanh(gate("c"))
    o = torch.sigmoid(gate("o"))
    c2 = f * c + i * g
    h2 = o * torch.tanh(c2)
    return h2, c2


def _transformer_step(params, k_cache, v_cache, pos, x, heads):
    """One batched transformer-layer decode step over a ring-buffer KV
    cache: write this step's k/v at ``pos % kv_max`` per row, attend over
    the ``min(pos+1, kv_max)`` live entries, add the FFN. Dead slots are
    masked to -inf before the softmax, so they weigh exactly 0 (every
    row has at least one live entry)."""
    kv_max = k_cache.shape[1]
    embed = x.shape[-1]
    dh = embed // heads
    q = x @ params["wq"].T
    k = x @ params["wk"].T
    v = x @ params["wv"].T
    slots = torch.arange(kv_max, device=x.device)
    onehot = slots[None, :] == (pos % kv_max)[:, None]  # (B, T)
    k_cache2 = torch.where(onehot[:, :, None], k[:, None, :], k_cache)
    v_cache2 = torch.where(onehot[:, :, None], v[:, None, :], v_cache)
    live = torch.clamp(pos + 1, max=kv_max)
    mask = slots[None, :] < live[:, None]  # (B, T)
    qh = q.reshape(-1, heads, dh)
    kh = k_cache2.reshape(-1, kv_max, heads, dh)
    vh = v_cache2.reshape(-1, kv_max, heads, dh)
    # the scale in the input's dtype, as the reference's jnp.sqrt
    scale = float(np.sqrt(np.asarray(dh, np.float32)))
    scores = torch.einsum("bhd,bthd->bht", qh, kh) / scale
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,bthd->bhd", attn, vh).reshape(-1, embed)
    y = x + ctx @ params["wo"].T
    ff = torch.relu(y @ params["w1"].T) @ params["w2"].T
    return k_cache2, v_cache2, pos + 1, y + ff


# --- model deployment (the ingest path the dedup detector watches) ----

def _gen_dense(kind: str, hidden: int, heads: int,
               rng: "np.random.Generator") -> Dict[str, np.ndarray]:
    scale = 1.0 / np.sqrt(hidden)
    out: Dict[str, np.ndarray] = {}
    if kind == "lstm":
        for name in LSTM_WEIGHTS:
            if name.startswith("b_"):
                out[name] = np.zeros((hidden, 1), np.float32)
            else:
                out[name] = (rng.standard_normal((hidden, hidden))
                             * scale).astype(np.float32)
    else:
        ffn = 2 * hidden
        for name in ("wq", "wk", "wv", "wo"):
            out[name] = (rng.standard_normal((hidden, hidden))
                         * scale).astype(np.float32)
        out["w1"] = (rng.standard_normal((ffn, hidden))
                     * scale).astype(np.float32)
        out["w2"] = (rng.standard_normal((hidden, ffn))
                     * scale).astype(np.float32)
    return out


def decode_weights(kind: str = "lstm", hidden: int = 64, heads: int = 4,
                   seed: int = 0, base_seed: Optional[int] = None,
                   finetune_frac: float = 0.25,
                   block: Tuple[int, int] = (32, 32)
                   ) -> Dict[str, np.ndarray]:
    """The dense weights :func:`deploy_decode_model` loads, made on the
    host from the seeds (the same numpy stream as the reference)."""
    if kind not in DECODE_KINDS:
        raise ValueError(f"kind must be one of {DECODE_KINDS}, "
                         f"got {kind!r}")
    rng = np.random.default_rng(base_seed if base_seed is not None
                                else seed)
    dense = _gen_dense(kind, hidden, heads, rng)
    if base_seed is not None:
        tune = np.random.default_rng(seed)
        for name, w in dense.items():
            if w.shape[1] == 1:
                continue  # biases stay shared
            bh, bw = block
            gh = max(1, w.shape[0] // bh)
            gw = max(1, w.shape[1] // bw)
            n_tiles = gh * gw
            picked = tune.choice(n_tiles,
                                 size=max(1, int(finetune_frac * n_tiles)),
                                 replace=False)
            for t in picked:
                i, j = divmod(int(t), gw)
                w[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw] += (
                    tune.standard_normal((min(bh, w.shape[0] - i * bh),
                                          min(bw, w.shape[1] - j * bw)))
                    * 0.01).astype(np.float32)
    return dense


def deploy_decode_model(client, db: str, *, kind: str = "lstm",
                        hidden: int = 64, heads: int = 4,
                        seed: int = 0, base_seed: Optional[int] = None,
                        finetune_frac: float = 0.25,
                        block: Tuple[int, int] = (32, 32)) -> Dict:
    """Create ``db`` and load one decode model's weight sets through
    ``client`` (in-process or remote).

    ``base_seed`` models fine-tuning: weights generate from the base
    seed, then ``finetune_frac`` of each tensor's block-grid tiles
    (chosen by ``seed``) are perturbed — two variants deployed from one
    base share exactly ``1 - finetune_frac`` of their weight pages bit
    for bit. Returns the model spec."""
    dense = decode_weights(kind, hidden, heads, seed, base_seed,
                           finetune_frac, block)
    client.create_database(db)
    for name, w in dense.items():
        client.create_set(db, name, type_name="matrix")
        shape = (block[0], 1) if w.shape[1] == 1 else tuple(block)
        client.send_matrix(db, name, w, block_shape=shape)
    return {"kind": kind, "hidden": int(hidden), "heads": int(heads)}


# --- the per-daemon decode runtime ------------------------------------

class DecodeRuntime:
    """Per-daemon model registry and batched step executor: owns the
    device-resident dense weights of every registered decode model and
    runs one padded, bucketed step program over a session batch. It
    keeps no session state (``serve/sessions.py`` does); it maps
    ``(states, inputs) → (states', outputs)``."""

    def __init__(self, library, *, model_dedup: bool = False,
                 kv_max: int = 64, dedup_bands: int = 16):
        self._library = library
        self._model_dedup = bool(model_dedup)
        self._kv_max = int(kv_max)
        self._dedup_bands = int(dedup_bands)
        self._mu = TrackedLock("DecodeRuntime._mu")
        # db -> {"spec", "params" (device dense), "client",
        #        "fps" {(set, idx): hash}, "page_bytes" {hash: nbytes}}
        self._models: Dict[str, Dict[str, Any]] = {}
        self._dedup_report: Optional[Dict[str, Any]] = None

    # -- registration / residency -------------------------------------
    def register_model(self, db: str, kind: str,
                       client: Optional[str] = None,
                       heads: Optional[int] = None) -> Dict[str, Any]:
        """Load ``db``'s weight sets as dense tensors on the library's
        device (idempotent), fingerprinting every weight page; with
        ``model_dedup`` and a second model registered, pool every
        registered model's sets through ``Client.dedup_resident``."""
        with self._mu:
            reg = self._models.get(db)
            if reg is not None:
                return reg["spec"]
        if kind not in DECODE_KINDS:
            raise ValueError(f"unknown decode kind {kind!r}")
        names = LSTM_WEIGHTS if kind == "lstm" else TRANSFORMER_WEIGHTS
        tensors = {n: self._library.get_tensor(db, n) for n in names}
        fps: Dict[Tuple[str, tuple], str] = {}
        page_bytes: Dict[str, int] = {}
        for n, t in tensors.items():
            bh, bw = t.meta.block_shape
            for idx, h in _detector.block_fingerprints(t).items():
                fps[(n, idx)] = h
                page_bytes[h] = bh * bw * t.data.element_size()
        hidden = tensors[names[0]].meta.shape[0]
        spec = {"kind": kind, "hidden": int(hidden),
                "heads": int(heads or 4), "kv_max": self._kv_max}
        params = {n: t.data[:t.meta.shape[0], :t.meta.shape[1]]
                  .contiguous().clone() for n, t in tensors.items()}
        if kind == "lstm":
            for b in ("b_i", "b_f", "b_c", "b_o"):
                params[b] = params[b].reshape(-1)
        with self._mu:
            self._models[db] = {"spec": spec, "params": params,
                                "client": client, "fps": fps,
                                "page_bytes": page_bytes}
            pool_now = self._model_dedup and len(self._models) > 1
            dbs = list(self._models)
        if pool_now:
            sets = [(d, n) for d in dbs for n in self._weight_names(d)]
            report = self._library.dedup_resident(
                sets, bands=self._dedup_bands)
            with self._mu:
                self._dedup_report = report
            obs.REGISTRY.gauge("dedup.page_bytes").set(
                int(report.get("hbm_bytes_pooled", 0)))
        return spec

    def _weight_names(self, db: str) -> Sequence[str]:
        kind = self._models[db]["spec"]["kind"]
        return LSTM_WEIGHTS if kind == "lstm" else TRANSFORMER_WEIGHTS

    def spec(self, db: str) -> Optional[Dict[str, Any]]:
        with self._mu:
            reg = self._models.get(db)
            return dict(reg["spec"]) if reg else None

    def drop_model(self, db: str) -> bool:
        with self._mu:
            return self._models.pop(db, None) is not None

    def residency_report(self) -> Dict[str, Any]:
        """Exact multi-model residency accounting: ``charged`` splits
        every page's bytes across the models referencing it
        (``page_bytes / refcount``) and rolls up per client, so the
        charges sum to the unique-page total."""
        with self._mu:
            refs: Dict[str, int] = {}
            for reg in self._models.values():
                for h in set(reg["fps"].values()):
                    refs[h] = refs.get(h, 0) + 1
            sized: Dict[str, int] = {}
            for reg in self._models.values():
                sized.update(reg["page_bytes"])
            unique_bytes = sum(sized.get(h, 0) for h in refs)
            charged: Dict[str, float] = {}
            by_model: Dict[str, float] = {}
            for db, reg in self._models.items():
                share = sum(sized.get(h, 0) / refs[h]
                            for h in set(reg["fps"].values()))
                by_model[db] = share
                who = reg.get("client") or db
                charged[who] = charged.get(who, 0.0) + share
            out = {
                "models": len(self._models),
                "unique_page_bytes": int(unique_bytes),
                "total_page_bytes": int(sum(
                    sum(sized.get(h, 0) for h in set(reg["fps"].values()))
                    for reg in self._models.values())),
                "charged_bytes": {k: int(round(v))
                                  for k, v in charged.items()},
                "charged_by_model": {k: int(round(v))
                                     for k, v in by_model.items()},
                "model_dedup": self._model_dedup,
            }
            if self._dedup_report is not None:
                out["pool"] = dict(self._dedup_report)
        return out

    # -- state ---------------------------------------------------------
    def state_layers(self, db: str) -> Dict[str, Tuple]:
        """{layer name: shape} of one session's state for ``db``."""
        spec = self.spec(db)
        if spec is None:
            raise KeyError(db)
        h = spec["hidden"]
        if spec["kind"] == "lstm":
            return {"h": (h,), "c": (h,)}
        return {"k": (spec["kv_max"], h), "v": (spec["kv_max"], h),
                "pos": ()}

    def init_state(self, db: str) -> Dict[str, torch.Tensor]:
        """A fresh session's state, zeros on the library's device."""
        device = self._library.device
        return {layer: torch.zeros(shape, device=device,
                                   dtype=torch.int32 if layer == "pos"
                                   else torch.float32)
                for layer, shape in self.state_layers(db).items()}

    def state_nbytes(self, db: str) -> int:
        return sum(int(np.prod(s or (1,))) * 4
                   for s in self.state_layers(db).values())

    # -- the batched step ----------------------------------------------
    def step_batch(self, db: str, states: List[Dict[str, Any]],
                   xs: List[Any]
                   ) -> Tuple[List[Dict[str, torch.Tensor]],
                              List[np.ndarray]]:
        """Advance ``len(states)`` sessions of one model by one step in
        one padded program call. Returns per-session new states (on the
        device) and outputs (host arrays); row independence makes each
        session's result bit-equal to a solo run."""
        with self._mu:
            reg = self._models.get(db)
        if reg is None:
            raise KeyError(f"model {db!r} not registered")
        spec = reg["spec"]
        params = reg["params"]
        device = self._library.device
        n = len(states)
        bucket = decode_bucket(n)
        pad = bucket - n
        hidden = spec["hidden"]

        def stack(layer, shape, dtype=torch.float32):
            rows = [torch.as_tensor(s[layer], dtype=dtype).to(device)
                    for s in states]
            rows += [torch.zeros(shape, dtype=dtype, device=device)] * pad
            return torch.stack(rows)

        x = torch.stack(
            [torch.as_tensor(np.asarray(v, np.float32)).to(device)
             for v in xs]
            + [torch.zeros((hidden,), device=device)] * pad)
        with torch.inference_mode():
            if spec["kind"] == "lstm":
                fn = _program(("lstm", hidden, bucket), _lstm_step)
                h2, c2 = fn(params, stack("h", (hidden,)),
                            stack("c", (hidden,)), x)
                new = [{"h": h2[i], "c": c2[i]} for i in range(n)]
                y = h2
            else:
                kv = spec["kv_max"]
                heads = spec["heads"]
                fn = _program(
                    ("transformer_layer", hidden, kv, heads, bucket),
                    lambda p, kc, vc, ps, xx: _transformer_step(
                        p, kc, vc, ps, xx, heads))
                k2, v2, pos2, y = fn(
                    params, stack("k", (kv, hidden)),
                    stack("v", (kv, hidden)),
                    stack("pos", (), torch.int32), x)
                new = [{"k": k2[i], "v": v2[i], "pos": pos2[i]}
                       for i in range(n)]
            host = y[:n].cpu().numpy()
        outs = [host[i] for i in range(n)]
        with _mu:
            _stats["batches"] += 1
            _stats["steps"] += n
            _stats["pad_rows"] += pad
        return new, outs
