"""GRU language-model training: Adam + sparse cross-entropy on one device.

The train step runs the time-major forward (``models/gru_textgen.
forward_sequence(time_major=True)``), whose time loop at bfloat16 on a GPU is
the fused kernel pair of ``ops/fused_gru_train``, and at float32 a plain loop
under autograd. Mixed precision follows the master-weights recipe: bfloat16
runs the products and stores the states in bf16, while the parameters, the
gradients at the parameter boundary, the Adam state and the loss stay
float32.

Adam is written out here with optax's defaults and order of operations
(``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside the square root
of the bias-corrected second moment), so that a run can be continued from an
optax state (``convert.adam_state_from_numpy``).

Every operation of a step is reproducible run to run on one device (no
floating-point atomics: the embedding gradient is a one-hot product, the
fused backward sums in a fixed order), which is what makes the resume exact.

Training on a device mesh (the data- and tensor-parallel train step, the
batch-local train kernels with summed weight gradients) is slice 13 of the
port: ROADMAP.md, Queue A #1b. The mesh, the placement rules and sharded
serving are in ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device, resolve_dtype
from ggml_experiments_tpu_torch.models import gru_textgen
from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig, GRUTextGenParams
from ggml_experiments_tpu_torch.ops.gru import GRUCellParams

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3   # Keras adam default
    epochs: int = 20
    log_every: int = 50
    checkpoint_path: Optional[str] = None   # best-by-loss .gxt
    remat: bool = False           # checkpoint the plain loop's cell
    eval_every: int = 0           # >0: held-out ppl every N steps (needs eval data)
    # Exact resume: ``resume_path`` holds the FULL train state (params + Adam
    # state + step + best loss); ``save_every > 0`` rewrites it every N steps,
    # and a train() started with an existing resume_path continues bit-exactly
    # where the interrupted run stopped.
    resume_path: Optional[str] = None
    save_every: int = 0
    compute_dtype: Any = torch.float32


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor       # () int32, on the CPU: steps taken
    mu: GRUTextGenParams      # first moments, shaped like the params
    nu: GRUTextGenParams      # second moments


def param_leaves(params: GRUTextGenParams) -> List[Tuple[str, torch.Tensor]]:
    """(key path, tensor) of every trainable tensor, in checkpoint order."""
    named = [("embeddings", params.embeddings), ("cell/kernel", params.cell.kernel),
             ("cell/recurrent_kernel", params.cell.recurrent_kernel),
             ("cell/bias", params.cell.bias), ("dense_kernel", params.dense_kernel),
             ("dense_bias", params.dense_bias)]
    for name, t in named:
        if t is not None and not isinstance(t, torch.Tensor):
            raise TypeError(f"training takes float parameters; {name} is {type(t).__name__}")
    return [(n, t) for n, t in named if t is not None]


def _map_params(fn, params: GRUTextGenParams) -> GRUTextGenParams:
    def opt(t):
        return None if t is None else fn(t)

    return GRUTextGenParams(
        embeddings=fn(params.embeddings),
        cell=GRUCellParams(kernel=fn(params.cell.kernel),
                           recurrent_kernel=fn(params.cell.recurrent_kernel),
                           bias=opt(params.cell.bias)),
        dense_kernel=fn(params.dense_kernel), dense_bias=opt(params.dense_bias))


def adam_init(params: GRUTextGenParams) -> Tuple[AdamState]:
    """Zero moments and count, as a one-element tuple (key paths
    ``opt_state/0/...``, where optax's chained state keeps them)."""
    param_leaves(params)
    return (AdamState(count=torch.zeros((), dtype=torch.int32),
                      mu=_map_params(lambda t: torch.zeros_like(t, requires_grad=False), params),
                      nu=_map_params(lambda t: torch.zeros_like(t, requires_grad=False), params)),)


def sparse_softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy from logits. The log-sum-exp runs in float32 even
    when the forward ran in bfloat16, and the true-class logit is picked with
    a one-hot product, whose gradient is reproducible."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(targets.long(), logits.shape[-1]).to(torch.float32)
    true_logit = (logits * onehot).sum(dim=-1)
    return (lse - true_logit).mean()


def loss_fn(params: GRUTextGenParams, inputs, targets, *, remat: bool = False,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, T) ``inputs`` against ``targets``.
    The forward runs time-major: only the int ids are transposed."""
    dev = params.device
    inputs = torch.as_tensor(inputs, device=dev)
    targets = torch.as_tensor(targets, device=dev)
    logits_tm, _ = gru_textgen.forward_sequence(
        params, inputs.t(), remat=remat, compute_dtype=compute_dtype, time_major=True)
    return sparse_softmax_cross_entropy(logits_tm, targets.t())


def adam_update(params: GRUTextGenParams, grads, state: AdamState, learning_rate: float) -> None:
    """One Adam step in place on ``params`` and ``state``."""
    count = int(state.count) + 1
    state.count.fill_(count)
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(count))
    with torch.no_grad():
        for (_, p), (_, mu), (_, nu), g in zip(param_leaves(params), param_leaves(state.mu),
                                               param_leaves(state.nu), grads):
            g = g.to(torch.float32)
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            update = (mu / bc1) / ((nu / bc2).sqrt() + ADAM_EPS)
            p.add_(update, alpha=-learning_rate)


def make_train_step(learning_rate: float, *, remat: bool = False,
                    compute_dtype=torch.float32) -> Callable:
    """The (params, opt_state, inputs, targets) -> (params, opt_state, loss)
    step. It updates ``params`` and ``opt_state`` in place and returns them;
    the loss comes back as a tensor on the device, not yet read."""
    cd = resolve_dtype(compute_dtype)

    def train_step(params, opt_state, inputs, targets):
        leaves = [t for _, t in param_leaves(params)]
        loss = loss_fn(params, inputs, targets, remat=remat, compute_dtype=cd)
        grads = torch.autograd.grad(loss, leaves)
        adam_update(params, grads, opt_state[0], learning_rate)
        return params, opt_state, loss.detach()

    return train_step


def _train_copy(params: GRUTextGenParams, dev: torch.device) -> GRUTextGenParams:
    """Float32 leaf copies on ``dev`` that require grad: the caller's tensors
    are never updated in place."""
    param_leaves(params)
    return _map_params(
        lambda t: t.detach().to(device=dev, dtype=torch.float32, copy=True).requires_grad_(True),
        params)


def _load_resume(path: str, params: GRUTextGenParams, opt_state, dev):
    from ggml_experiments_tpu_torch.formats.checkpoint import load_into

    state = load_into(path, {"params": params, "opt_state": opt_state,
                             "step": np.zeros((), np.int32), "best": np.zeros((), np.float32)},
                      device=dev)
    # a clear mismatch error instead of a shape failure deep inside a step
    # (the stream itself cannot be validated: resume assumes the same seeded
    # batches, which skipping start_step relies on)
    for (name, old), (_, new) in zip(param_leaves(params), param_leaves(state["params"])):
        if old.shape != new.shape:
            raise ValueError(f"resume checkpoint {path} does not match this model: {name} is "
                             f"{tuple(new.shape)}, expected {tuple(old.shape)}")
    new_params = _train_copy(state["params"], dev)
    adam = state["opt_state"][0]
    adam.count = adam.count.to(device="cpu", dtype=torch.int32)
    return new_params, (adam,), int(state["step"]) + 1, float(state["best"])


def _validation_ppl(params: GRUTextGenParams, ev_in: torch.Tensor, ev_tg: torch.Tensor) -> float:
    with torch.no_grad():
        logits, _ = gru_textgen.forward_sequence(params, ev_in)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, ev_tg.long()[..., None])[..., 0]
        return float(torch.exp(nll.mean()))


def train(params: GRUTextGenParams, batches: Iterable[Tuple[Any, Any]],
          cfg: TrainConfig = TrainConfig(), *, device: DeviceLike = None,
          log: Optional[Callable[[dict], None]] = None,
          eval_seqs=None) -> Tuple[GRUTextGenParams, list]:
    """Run the training loop over an iterable of (inputs, targets) batches of
    (B, T) int arrays, on ``device`` (default ``cuda``; without a GPU that
    raises). Returns (params, history); the given params are copied, not
    updated.

    With ``cfg.checkpoint_path``, keeps the best-by-loss native checkpoint.
    ``eval_seqs`` ((B, T+1) int held-out windows) and ``cfg.eval_every`` add a
    validation perplexity to the history every N steps. With
    ``cfg.resume_path``, see :class:`TrainConfig`: the state is saved after
    the step ran, and a resumed run skips the batches already consumed."""
    from ggml_experiments_tpu_torch.formats import checkpoint as ckpt
    from ggml_experiments_tpu_torch.training.prefetch import prefetch_to_device

    dev = resolve_device(device)
    params = _train_copy(params, dev)
    opt_state = adam_init(params)
    start_step = 0
    resumed_best = None
    if cfg.resume_path and os.path.exists(cfg.resume_path):
        params, opt_state, start_step, resumed_best = _load_resume(
            cfg.resume_path, params, opt_state, dev)
    step_fn = make_train_step(cfg.learning_rate, remat=cfg.remat,
                              compute_dtype=cfg.compute_dtype)

    manager = None
    if cfg.checkpoint_path:
        manager = ckpt.CheckpointManager(cfg.checkpoint_path)
        if resumed_best is not None:
            # best-by-loss must survive the interruption too, or the first
            # resumed step would overwrite a better earlier checkpoint
            manager.best = resumed_best

    ev_in = ev_tg = None
    if cfg.eval_every and eval_seqs is not None:
        ev = torch.as_tensor(np.asarray(eval_seqs, np.int32), device=dev)
        ev_in, ev_tg = ev[:, :-1], ev[:, 1:]

    history = []
    t0 = time.time()
    if start_step:
        # the batch stream is deterministic (seeded): skip what the
        # interrupted run consumed, before prefetch transfers it
        batches = itertools.islice(batches, start_step, None)
    stream = prefetch_to_device(batches, device=dev)
    for i, (inputs, targets) in enumerate(stream, start=start_step):
        params, opt_state, loss = step_fn(params, opt_state, inputs, targets)
        if cfg.resume_path and cfg.save_every and i % cfg.save_every == 0:
            ckpt.save(cfg.resume_path, {
                "params": params, "opt_state": opt_state, "step": np.int32(i),
                "best": np.float32(manager.best if manager is not None else np.inf)})
        do_eval = ev_in is not None and i % cfg.eval_every == 0
        if i % cfg.log_every == 0 or manager is not None or do_eval:
            loss_val = float(loss)
            rec = {"step": i, "loss": loss_val, "elapsed_s": time.time() - t0}
            if do_eval:
                rec["val_ppl"] = _validation_ppl(params, ev_in, ev_tg)
            history.append(rec)
            if log is not None and i % cfg.log_every == 0:
                log(rec)
            if manager is not None:
                manager.maybe_save(params, loss_val)
    return params, history


def train_from_text(text: str, *, model_config: GRUConfig = GRUConfig(),
                    train_config: TrainConfig = TrainConfig(), data_config=None,
                    seed: int = 0, device: DeviceLike = None,
                    eval_text: Optional[str] = None, max_eval_windows: int = 32):
    """End to end: corpus text -> trained params. Returns (params, history,
    tokenizer). ``eval_text`` and a positive ``train_config.eval_every`` add
    held-out validation perplexity. ``seed`` names both the initial params
    and the batch stream."""
    from ggml_experiments_tpu_torch.training.data import DataConfig, make_examples
    from ggml_experiments_tpu_torch.training.data import batches as make_batches
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    dev = resolve_device(device)
    data_config = data_config or DataConfig()
    tok = CharTokenizer()
    examples = make_examples(text, tok, data_config)
    params = gru_textgen.init_params(model_config, torch.Generator().manual_seed(seed),
                                     device=dev)
    stream = make_batches(examples, data_config, seed=seed, epochs=train_config.epochs)
    eval_seqs = None
    if eval_text is not None:
        eval_seqs = make_examples(eval_text, tok, data_config)[:max_eval_windows]
    params, history = train(params, stream, train_config, device=dev, eval_seqs=eval_seqs)
    return params, history, tok
