"""Continuous-batching generation engine for the GRU text generator.

A fixed pool of B decode *slots* lives on the device; the host enqueues
requests, a tick advances all slots ``inner_steps`` tokens per call, finished
slots are evicted and refilled without stalling the others. Per-slot prefill
is teacher-forcing: while ``pos < prompt_len`` a slot consumes prompt tokens,
afterwards its own argmax/sample -- the semantics of
``models.gru_textgen.generate``, so a continuous-batched request reproduces
the offline decode.

Two ticks: ``_slot_scan`` (a loop of PyTorch ops, a quantized recurrent
projection through its qmatmul kernel) and the persistent fused tick kernel
(``ops.fused_gru_decode.fused_slot_tick``). Refill decisions come from a host
shadow of the deterministic cursors (no device reads), and token readbacks
trail the ticks by up to ``fetch_depth`` ticks as async copies.

``snapshot`` / ``restore`` persist one process's engine (device slots,
in-flight and queued requests) in the ``.gxt`` container; the JAX package's
engine reads these files and writes the same.

Multi-process serving (``torch.distributed``; ``parallel/``): every process
builds the same engine over params placed on one mesh and drives the same
loop. The primary (rank 0) owns the request queue; every tick its refill
decisions (mask, prompts, lengths, totals, temperatures) are broadcast, so
the replicated slot state mutates in lockstep on every rank. The fused tick
is slot-sharded over the ``data`` axis (else the first mesh axis wider than
one rank) when the padded slot count divides it: each rank ticks its slots
and the results are all-gathered back; sampled slots draw noise keyed on
their shard's first slot, so shards draw distinct streams. Tensor-parallel
params take the scan tick, whose gate products are sharded. Only the
primary holds requests and delivers tokens; it writes ``snapshot``, and
``restore`` rebuilds the engine in a fresh single process. When a peer dies,
the survivors' next collective fails (or stalls until the group's timeout):
a tick never completes without every rank.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.models.gru_textgen import GRUTextGenParams, gather_for_loop
from ggml_experiments_tpu_torch.parallel import multihost
from ggml_experiments_tpu_torch.parallel.mesh import AXES, DATA_AXIS
from ggml_experiments_tpu_torch.parallel.sharding import mesh_of


# The engine runs the fused tick kernel (block-quantized weights on a CUDA
# device) from this many slots and inner steps on, and at f32 up to
# FUSED_TICK_MAX_SLOTS_F32 slots: the whole engine's tokens/s, fused tick
# against scan tick, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (tools/torch_gate_sweep.py; PERF.md, "Dispatch gates"). At bf16 the
# fused tick won every cell from 16 x 16 to 1024 x 128 (2.4-14x); at f32 it
# won up to 512 slots (1.4-4.7x) and lost or tied at 1024 slots from 32 inner
# steps, where its CUDA-core products fall behind the scan's 3xTF32 qmatmul.
FUSED_TICK_MIN_SLOTS = 16
FUSED_TICK_MIN_INNER = 16
FUSED_TICK_MAX_SLOTS_F32 = 512


@dataclasses.dataclass
class SlotState:
    """Device-resident decode state for all slots."""

    h: torch.Tensor       # (B, U) f32 recurrent state
    prev: torch.Tensor    # (B,) int32 previous prediction
    pos: torch.Tensor     # (B,) int32 tokens consumed so far
    total: torch.Tensor   # (B,) int32 prompt_len + max_new_tokens
    plen: torch.Tensor    # (B,) int32 prompt length
    prompt: torch.Tensor  # (B, Pmax) int32 prompt ids
    temp: torch.Tensor    # (B,) f32 per-request temperature; <=0 -> greedy


def init_state(params: GRUTextGenParams, n_slots: int, max_prompt: int) -> SlotState:
    dev = params.device
    zi = lambda: torch.zeros((n_slots,), dtype=torch.int32, device=dev)  # noqa: E731
    return SlotState(
        h=torch.zeros((n_slots, params.units), dtype=torch.float32, device=dev),
        prev=zi(), pos=zi(), total=zi(), plen=zi(),  # total == 0 -> slot idle
        prompt=torch.zeros((n_slots, max_prompt), dtype=torch.int32, device=dev),
        temp=torch.zeros((n_slots,), dtype=torch.float32, device=dev),
    )


def _slot_scan(params: GRUTextGenParams, state: SlotState, seed: int, inner_steps: int,
               compute_dtype=torch.float32, enable_sampling: bool = False,
               top_k=None, top_p=None):
    """Advance every slot ``inner_steps`` tokens. Returns (state, toks, valid)
    with toks/valid shaped (B, inner_steps); valid marks tokens of a live
    request. Sampling draws from a generator seeded with ``seed``."""
    from ggml_experiments_tpu_torch.ops import sampling
    from ggml_experiments_tpu_torch.ops.gru import (
        gru_combine,
        input_projection,
        recurrent_projection,
    )
    from ggml_experiments_tpu_torch.ops.linear import linear

    cd = resolve_dtype(compute_dtype)
    params = gather_for_loop(params)   # tensor-parallel params: products stay sharded
    dev = params.device
    gen = torch.Generator(device=dev).manual_seed(int(seed)) if enable_sampling else None
    # loop-invariant: per-step x-projection becomes a vocab-table gather
    proj = input_projection(params.cell, params.embeddings, compute_dtype=cd)
    h, prev, pos = state.h, state.prev.long(), state.pos.long()
    total, plen = state.total.long(), state.plen.long()
    prompt = state.prompt.long()
    pmax = prompt.shape[1] - 1
    b = h.shape[0]
    toks = torch.empty((b, inner_steps), dtype=torch.int64, device=dev)
    valid = torch.empty((b, inner_steps), dtype=torch.bool, device=dev)
    for j in range(inner_steps):
        active = pos < total
        pcur = prompt.gather(1, pos.clamp(max=pmax)[:, None])[:, 0]
        tok = torch.where(pos < plen, pcur, prev)
        h_new = gru_combine(proj[tok], recurrent_projection(params.cell, h, compute_dtype=cd), h)
        logits = linear(h_new, params.dense_kernel, params.dense_bias, compute_dtype=cd)
        greedy = torch.argmax(logits, dim=-1)
        if enable_sampling:
            scaled = logits.float() / torch.clamp_min(state.temp, 1e-6)[:, None]
            if top_k is not None:
                scaled = sampling.apply_top_k(scaled, top_k)
            if top_p is not None:
                scaled = sampling.apply_top_p(scaled, top_p)
            sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=gen)[:, 0]
            pred = torch.where(state.temp > 0.0, sampled, greedy)
        else:
            pred = greedy
        h = torch.where(active[:, None], h_new, h)
        prev = torch.where(active, pred, prev)
        pos = pos + active.long()
        toks[:, j] = tok
        valid[:, j] = active
    if params.vocab_size <= 255:
        toks = toks.to(torch.uint8)  # readback is per tick: ship the smallest type
    else:
        toks = toks.to(torch.int32)
    new = dataclasses.replace(state, h=h, prev=prev.to(torch.int32), pos=pos.to(torch.int32))
    return new, toks, valid


def _reset_slots(state: SlotState, mask, prompt, plen, total, temp) -> SlotState:
    """Install new requests into masked slots (mask (B,) bool; full-size host
    arrays)."""
    dev = state.h.device
    m = torch.as_tensor(mask, device=dev)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return SlotState(
        h=torch.where(m[:, None], torch.zeros_like(state.h), state.h),
        prev=torch.where(m, torch.zeros_like(state.prev), state.prev),
        pos=torch.where(m, torch.zeros_like(state.pos), state.pos),
        total=torch.where(m, t(total, torch.int32), state.total),
        plen=torch.where(m, t(plen, torch.int32), state.plen),
        prompt=torch.where(m[:, None], t(prompt, torch.int32), state.prompt),
        temp=torch.where(m, t(temp, torch.float32), state.temp),
    )


@dataclasses.dataclass
class Request:
    prompt_ids: np.ndarray
    max_new_tokens: int
    id: int = -1
    temperature: float = 0.0
    on_token: Optional[Callable[[int], None]] = None  # streaming callback
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)
    _tokens: List[int] = dataclasses.field(default_factory=list)
    _canceled: bool = False
    _error: Optional[Exception] = None  # set when the engine died under us

    def cancel(self) -> None:
        """Stop generating for this request: queued requests never start,
        in-flight slots are freed at the next refill; ``result()`` returns
        the tokens delivered so far."""
        self._canceled = True
        self._done.set()

    @property
    def canceled(self) -> bool:
        return self._canceled

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until finished (or canceled); returns prompt echo +
        generated tokens. Raises RuntimeError if the engine died first."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished")
        if self._error is not None:
            raise RuntimeError(f"request {self.id} aborted by engine failure") from self._error
        return np.asarray(self._tokens, np.int32)


@dataclasses.dataclass
class EngineStats:
    tokens_generated: int = 0
    requests_completed: int = 0
    requests_canceled: int = 0
    device_steps: int = 0
    wall_time_s: float = 0.0
    fetch_depth_shrinks: int = 0
    fetch_depth_recoveries: int = 0
    refill_s: float = 0.0         # host queue work: evict/install/shadow math
    dispatch_s: float = 0.0       # tick call until the async dispatch returns
    readback_wait_s: float = 0.0  # blocking wait on the oldest fetch
    distribute_s: float = 0.0     # handing fetched tokens to their requests
    backpressure_s: float = 0.0   # fetch_async: loop blocked on a full queue
    readback_bytes: int = 0       # payload synced back to the host

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_time_s if self.wall_time_s else 0.0

    def breakdown(self) -> dict:
        """Per-phase shares of the engine wall clock + readback link rate."""
        acc = self.refill_s + self.dispatch_s + self.readback_wait_s + self.distribute_s
        return {
            "wall_s": round(self.wall_time_s, 4),
            "refill_s": round(self.refill_s, 4),
            "dispatch_s": round(self.dispatch_s, 4),
            "readback_wait_s": round(self.readback_wait_s, 4),
            "distribute_s": round(self.distribute_s, 4),
            "backpressure_s": round(self.backpressure_s, 4),
            "other_s": round(max(0.0, self.wall_time_s - acc), 4),
            "readback_bytes": self.readback_bytes,
            "readback_MB_per_s": round(
                self.readback_bytes / self.readback_wait_s / 1e6, 2
            ) if self.readback_wait_s else None,
        }


def fused_tick_route(params: GRUTextGenParams, n_slots: int, inner_steps: int,
                     compute_dtype, use_fused_tick: Optional[bool] = None,
                     device=None) -> bool:
    """Whether an engine of ``n_slots`` x ``inner_steps`` ticks on the
    persistent kernel (``device`` defaults to the params'). ``None`` decides:
    block-quantized params on a CUDA device, at least FUSED_TICK_MIN_SLOTS x
    FUSED_TICK_MIN_INNER, at f32 at most FUSED_TICK_MAX_SLOTS_F32 slots, and
    a plan of the kernel that takes the model's (U, V) (``kernel_refusal``);
    else the scan tick. ``True`` raises, with the reason, where the params
    are not block-quantized or no plan of the kernel takes them on a CUDA
    device (the CPU's plain version takes any shape)."""
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import is_fusable_params, kernel_refusal

    cd = resolve_dtype(compute_dtype)
    quantized = is_fusable_params(params)
    dev = torch.device(device) if device is not None else params.device
    if use_fused_tick is None:
        return bool(quantized and dev.type == "cuda" and n_slots >= FUSED_TICK_MIN_SLOTS
                    and inner_steps >= FUSED_TICK_MIN_INNER
                    and (cd == torch.bfloat16 or n_slots <= FUSED_TICK_MAX_SLOTS_F32)
                    and not kernel_refusal(params, n_slots, cd, dev))
    if use_fused_tick and not quantized:
        raise ValueError("use_fused_tick requires block-quantized params "
                         "(cell, recurrent and dense kernels all QTensors)")
    why = kernel_refusal(params, n_slots, cd, dev) if use_fused_tick else ""
    if why:
        raise ValueError(f"use_fused_tick: {why}")
    return bool(use_fused_tick)


class DecodeEngine:
    """Slot-based continuous batching over one tick function.

    Thread-safe: ``submit`` from any thread; ``start`` runs a background
    worker, ``run_until_idle`` drives it synchronously. Runs on the params'
    device."""

    def __init__(
        self,
        params: GRUTextGenParams,
        *,
        n_slots: int = 8,
        max_prompt: int = 64,
        inner_steps: int = 16,
        compute_dtype=torch.float32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        enable_sampling: Optional[bool] = None,
        seed: int = 0,
        fetch_depth: int = 2,
        fetch_stall_s: float = 5.0,
        fetch_async: bool = False,
        max_pending: Optional[int] = None,
        use_fused_tick: Optional[bool] = None,
    ):
        from ggml_experiments_tpu_torch.ops.fused_gru_decode import SLOT_LANES

        self.params = params
        self.default_temperature = temperature
        self.n_slots = n_slots
        self.max_prompt = max_prompt
        self.inner_steps = inner_steps
        self.state = init_state(params, n_slots, max_prompt)
        self._seed = int(seed)
        self._tick_count = 0
        self.sampling_enabled = (
            enable_sampling if enable_sampling is not None else temperature > 0.0)
        self._compute_dtype = resolve_dtype(compute_dtype)
        self._top_k = top_k
        self._top_p = top_p
        self.use_fused_tick = fused_tick_route(params, n_slots, inner_steps,
                                               self._compute_dtype, use_fused_tick)
        # in a process group: the mesh the params were placed on; the fused
        # tick's slots split over its data axis (else the first wider axis)
        # where the padded slots divide, and over the data axis of a
        # one-rank mesh, whose collectives run on that rank
        self._multiproc = multihost.in_session()
        self._mesh = mesh_of(params)
        if self._multiproc and self._mesh is None:
            raise ValueError("a DecodeEngine in a process group needs params placed on a "
                             "mesh (parallel.place)")
        self._fused_slot_axis = None
        if self.use_fused_tick and self._multiproc:
            bp = -(-n_slots // SLOT_LANES) * SLOT_LANES
            wide = [ax for ax in AXES   # data first
                    if self._mesh.size(ax) > 1 and bp % self._mesh.size(ax) == 0]
            if wide:
                self._fused_slot_axis = wide[0]
            elif max(self._mesh.shape) == 1:
                self._fused_slot_axis = DATA_AXIS
        self.max_pending = max_pending
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._slot_req: Dict[int, Optional[Request]] = {i: None for i in range(n_slots)}
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = EngineStats()
        self.error: Optional[Exception] = None
        # the requests a restore() rebuilt from its snapshot, by id
        self.restored_requests: List[Request] = []
        # host shadow of the deterministic slot cursors: refill decisions
        # need no device read
        self._pos = np.zeros(n_slots, np.int64)
        self._total = np.zeros(n_slots, np.int64)
        # deferred token fetches: (host tokens, copy-done event, targets)
        self.fetch_depth = max(1, int(fetch_depth))
        self._configured_fetch_depth = self.fetch_depth
        self.fetch_stall_s = float(fetch_stall_s)
        self._fast_flushes = 0
        self._pending_fetch = deque()
        self.fetch_async = bool(fetch_async)
        self._fetch_q: Optional["queue.Queue"] = None
        self._stats_lock = threading.Lock()
        if self.fetch_async:
            self._fetch_q = queue.Queue(maxsize=self.fetch_depth)
            threading.Thread(target=self._fetch_loop, daemon=True).start()

    # -- public API ---------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, temperature: Optional[float] = None,
               on_token: Optional[Callable[[int], None]] = None) -> Request:
        """Queue a request. ``temperature`` overrides the engine default
        (needs a sampling-enabled engine). ``on_token`` streams each token id
        as it lands (called from the engine thread)."""
        if self.error is not None:
            raise RuntimeError(f"engine failed: {self.error!r}") from self.error
        prompt_ids = np.asarray(prompt_ids, np.int32)
        if prompt_ids.ndim != 1 or prompt_ids.size == 0:
            raise ValueError("prompt_ids must be a non-empty 1-D int array")
        if prompt_ids.size > self.max_prompt:
            raise ValueError(f"prompt longer than max_prompt={self.max_prompt}")
        if prompt_ids.min() < 0 or prompt_ids.max() >= self.params.vocab_size:
            raise ValueError(f"prompt ids must lie in [0, {self.params.vocab_size})")
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
        eff_temp = self.default_temperature if temperature is None else temperature
        if eff_temp > 0.0 and not self.sampling_enabled:
            raise ValueError("temperature > 0 requires a sampling-enabled engine (build "
                             "with temperature > 0 or enable_sampling=True)")
        if self.max_pending is not None and self._queue.qsize() >= self.max_pending:
            raise RuntimeError(f"engine backpressure: {self._queue.qsize()} requests "
                               f"already queued (max_pending={self.max_pending})")
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
        req = Request(prompt_ids=prompt_ids, max_new_tokens=max_new_tokens, id=req_id,
                      temperature=eff_temp, on_token=on_token)
        self._queue.put(req)
        return req

    def active_requests(self) -> List[Request]:
        return [r for r in self._slot_req.values() if r is not None]

    def pending_count(self) -> int:
        return self._queue.qsize()

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._flush_pending()

    def run_until_idle(self, timeout_s: float = 120.0):
        """Synchronous drive: process queued requests until all complete."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            busy = self._tick()
            if not busy and self._queue.empty():
                return
        raise TimeoutError("engine did not drain in time")

    def snapshot(self, path: str) -> None:
        """Persist engine state (device slots + in-flight/queued requests).

        Call with the background thread stopped (or from the driving thread
        in synchronous mode): a concurrent ``_tick`` would advance slots
        between the state capture and the request-progress capture."""
        from ggml_experiments_tpu_torch.formats import checkpoint

        # the last dispatched tick's tokens must land in the requests before
        # their progress is captured (the device state already includes them)
        self._flush_pending()
        pending = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req._canceled:
                pending.append(req)
        for req in pending:  # re-queue locally; the snapshot keeps a copy
            self._queue.put(req)

        inflight = {}
        for slot, req in self._slot_req.items():
            if req is not None and not req._canceled:
                inflight[str(slot)] = {
                    "prompt": req.prompt_ids,
                    "max_new": np.int32(req.max_new_tokens),
                    "tokens": np.asarray(req._tokens, np.int32),
                    "id": np.int32(req.id),
                    "temp": np.float32(req.temperature),
                }
        tree = {
            "state": self.state,
            "inflight": inflight,
            "pending": {
                str(i): {
                    "prompt": r.prompt_ids,
                    "max_new": np.int32(r.max_new_tokens),
                    "temp": np.float32(r.temperature),
                }
                for i, r in enumerate(pending)
            },
        }
        checkpoint.save(path, tree)

    @classmethod
    def restore(cls, path: str, params: GRUTextGenParams, **engine_kw) -> "DecodeEngine":
        """Rebuild an engine from a snapshot; in-flight requests resume at
        the exact token position they were interrupted at. The rebuilt
        requests are in ``restored_requests``, by id."""
        from ggml_experiments_tpu_torch.formats import checkpoint

        flat = checkpoint.load_arrays(path, device="cpu")
        fields = [f.name for f in dataclasses.fields(SlotState)]
        missing = [f for f in fields if f"state/{f}" not in flat]
        if missing:
            raise KeyError(f"{path}: not an engine snapshot (no state/{missing[0]})")
        n_slots, max_prompt = flat["state/prompt"].shape
        eng = cls(params, n_slots=n_slots, max_prompt=max_prompt, **engine_kw)
        dtypes = {"h": torch.float32, "temp": torch.float32}
        eng.state = SlotState(**{
            f: flat[f"state/{f}"].to(device=params.device, dtype=dtypes.get(f, torch.int32))
            for f in fields})
        eng._pos = flat["state/pos"].numpy().astype(np.int64)
        eng._total = flat["state/total"].numpy().astype(np.int64)

        def request(kind: str, key: str, req_id: int) -> Request:
            temp = flat.get(f"{kind}/{key}/temp")
            return Request(
                prompt_ids=flat[f"{kind}/{key}/prompt"].numpy().astype(np.int32),
                max_new_tokens=int(flat[f"{kind}/{key}/max_new"]), id=req_id,
                temperature=0.0 if temp is None else float(temp))

        by_slot: Dict[int, Request] = {}
        pending: Dict[int, Request] = {}
        for name in flat:
            parts = name.split("/")
            if len(parts) != 3 or parts[2] != "prompt":
                continue
            if parts[0] == "inflight":
                req = request("inflight", parts[1], int(flat[f"inflight/{parts[1]}/id"]))
                req._tokens = flat[f"inflight/{parts[1]}/tokens"].numpy().astype(int).tolist()
                # a request that had finished but still held its slot has all
                # its tokens already: nothing more will be delivered to it
                if len(req._tokens) >= req.prompt_ids.size + req.max_new_tokens:
                    req._done.set()
                by_slot[int(parts[1])] = req
            elif parts[0] == "pending":
                pending[int(parts[1])] = request("pending", parts[1], int(parts[1]))
        for slot, req in by_slot.items():
            if not 0 <= slot < n_slots:
                raise ValueError(f"{path}: in-flight request in slot {slot} of {n_slots}")
            eng._slot_req[slot] = req
        for idx in sorted(pending):
            eng._queue.put(pending[idx])
        eng._next_id = 1 + max(
            [r.id for r in by_slot.values()] + [r.id for r in pending.values()] + [-1])
        eng.restored_requests = sorted(
            list(by_slot.values()) + list(pending.values()), key=lambda r: r.id)
        return eng

    def state_digest(self) -> int:
        """A digest of the slot state (the sum of prev, and of |h| to 1e-3):
        equal on every rank of a session that kept lockstep."""
        prev = int(self.state.prev.long().sum())
        return prev + int(round(float(self.state.h.double().abs().sum()) * 1e3))

    # -- engine internals ---------------------------------------------------
    def _read_tokens(self, fetch) -> np.ndarray:
        """The blocking device->host readback (seam for fault injection)."""
        toks, event = fetch
        if event is not None:
            event.synchronize()
        return toks.numpy()

    def _deliver(self, fetch, targets, adapt: bool) -> None:
        """Readback one tick's tokens and hand them to their requests; a
        request completes here, once its final tokens landed."""
        t0 = time.perf_counter()
        toks = self._read_tokens(fetch)
        t1 = time.perf_counter()
        with self._stats_lock:
            self.stats.readback_wait_s += t1 - t0
            self.stats.readback_bytes += toks.nbytes
        if adapt:
            self._adapt_fetch_depth(t1 - t0)
        delivered = 0
        for slot, req, n in targets:
            if req._canceled:
                continue
            new_toks = toks[slot, :n].tolist()
            req._tokens.extend(new_toks)
            delivered += n
            if req.on_token is not None:
                for t in new_toks:
                    req.on_token(t)
            if len(req._tokens) >= req.prompt_ids.size + req.max_new_tokens:
                req._done.set()
        with self._stats_lock:
            self.stats.tokens_generated += delivered
            self.stats.distribute_s += time.perf_counter() - t1

    def _flush_one(self) -> None:
        fetch, targets = self._pending_fetch.popleft()
        self._deliver(fetch, targets, adapt=True)

    def _fetch_loop(self) -> None:
        """fetch_async reader: drains queued readbacks beside the loop."""
        while True:
            item = self._fetch_q.get()
            try:
                self._deliver(*item, adapt=False)
            except Exception as ex:  # pragma: no cover - device failure
                self.error = ex
                for _slot, req, _n in item[1]:
                    req._error = ex
                    req._done.set()
            finally:
                self._fetch_q.task_done()

    def _adapt_fetch_depth(self, readback_s: float) -> None:
        """Halve the live fetch depth after a readback slower than
        ``fetch_stall_s``; double it back after 128 fast ones."""
        if readback_s > self.fetch_stall_s:
            self._fast_flushes = 0
            if self.fetch_depth > 1:
                self.fetch_depth = max(1, self.fetch_depth // 2)
                self.stats.fetch_depth_shrinks += 1
        else:
            self._fast_flushes += 1
            if (self.fetch_depth < self._configured_fetch_depth
                    and self._fast_flushes >= 128):
                self.fetch_depth = min(self._configured_fetch_depth, self.fetch_depth * 2)
                self._fast_flushes = 0
                self.stats.fetch_depth_recoveries += 1

    def _flush_pending(self) -> None:
        if self.fetch_async:
            self._fetch_q.join()
            return
        while self._pending_fetch:
            self._flush_one()

    def _refill(self) -> bool:
        """Evict finished/canceled requests, install queued ones into idle
        slots, from the host cursor shadow. True if any slot is live."""
        for i, req in self._slot_req.items():
            if req is not None and req._canceled:
                self._total[i] = self._pos[i]
        idle = self._pos >= self._total
        mask = np.zeros(self.n_slots, bool)
        prompt = np.zeros((self.n_slots, self.max_prompt), np.int32)
        plen = np.zeros(self.n_slots, np.int32)
        tot = np.zeros(self.n_slots, np.int32)
        temp = np.zeros(self.n_slots, np.float32)
        for i in np.nonzero(idle)[0]:
            req = self._slot_req[i]
            if req is not None:
                self._slot_req[i] = None
                if req._canceled:
                    self.stats.requests_canceled += 1
                    mask[i] = True  # tot stays 0: clears the device slot
                else:
                    self.stats.requests_completed += 1
            new_req = None
            while new_req is None or new_req._canceled:
                try:
                    new_req = self._queue.get_nowait()
                except queue.Empty:
                    new_req = None
                    break
            if new_req is None:
                continue
            mask[i] = True
            p = new_req.prompt_ids
            prompt[i, : p.size] = p
            plen[i] = p.size
            tot[i] = p.size + new_req.max_new_tokens
            temp[i] = new_req.temperature
            self._slot_req[i] = new_req
        if self._multiproc:
            # every rank installs the primary's decisions (followers queue
            # nothing), so the replicated state moves in lockstep
            mask, prompt, plen, tot, temp = multihost.broadcast_one_to_all(
                (mask, prompt, plen, tot, temp))
        if mask.any():
            self.state = _reset_slots(self.state, mask, prompt, plen, tot, temp)
            self._pos[mask] = 0
            self._total[mask] = tot[mask]
        return bool((self._pos < self._total).any())

    def _tick(self) -> bool:
        from ggml_experiments_tpu_torch.ops.fused_gru_decode import fused_slot_tick

        t0 = time.perf_counter()
        if not self.fetch_async:
            while len(self._pending_fetch) >= self.fetch_depth:
                self._flush_one()
        t_refill = time.perf_counter()
        busy = self._refill()
        self.stats.refill_s += time.perf_counter() - t_refill
        if not busy:
            self._flush_pending()
            return False
        seed = (self._seed * 1_000_003 + self._tick_count) & 0x7FFFFFFF
        self._tick_count += 1
        t_dispatch = time.perf_counter()
        if self.use_fused_tick:
            self.state, toks = fused_slot_tick(
                self.params, self.state, self.inner_steps,
                compute_dtype=self._compute_dtype,
                enable_sampling=self.sampling_enabled, seed=seed,
                top_k=self._top_k if self.sampling_enabled else None,
                top_p=self._top_p if self.sampling_enabled else None,
                mesh=self._mesh if self._fused_slot_axis else None,
                slot_axis=self._fused_slot_axis,
            )
        else:
            self.state, toks, _valid = _slot_scan(
                self.params, self.state, seed, self.inner_steps,
                compute_dtype=self._compute_dtype, enable_sampling=self.sampling_enabled,
                top_k=self._top_k, top_p=self._top_p,
            )
        if toks.device.type == "cuda":
            host = toks.to("cpu", non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            fetch = (host, event)
        else:
            fetch = (toks, None)
        self.stats.dispatch_s += time.perf_counter() - t_dispatch
        n_new = np.minimum(self._total - self._pos, self.inner_steps)
        targets = [(i, req, int(n_new[i])) for i, req in self._slot_req.items()
                   if req is not None and n_new[i] > 0]
        self._pos = np.minimum(self._pos + self.inner_steps, self._total)
        if self.fetch_async:
            t_bp = time.perf_counter()
            self._fetch_q.put((fetch, targets))
            self.stats.backpressure_s += time.perf_counter() - t_bp
        else:
            self._pending_fetch.append((fetch, targets))
        self.stats.wall_time_s += time.perf_counter() - t0
        self.stats.device_steps += 1
        return True

    def _run(self):
        try:
            while not self._stop.is_set():
                if not self._tick():
                    time.sleep(0.001)
        except Exception as ex:  # device/runtime failure must not strand callers
            self.error = ex
            for req in list(self._slot_req.values()):
                if req is not None:
                    req._error = ex
                    req._done.set()
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                req._error = ex
                req._done.set()
