#!/usr/bin/env python3
"""DP + TP execution over a mesh of ranks on the port (the port's copy of
``examples/multichip.py``).

Shards the GRU gate kernels over the ``model`` axis (column-parallel), the
vocab head row-parallel and the batch over ``data``, then runs a training
step and a sharded decode. One process is a (1, 1) mesh; several processes
join one ``torch.distributed`` group, one device each (a rank's CUDA device
is ``LOCAL_RANK`` or its rank), from the usual environment variables:

    python3 examples/torch_multichip.py
    torchrun --nproc-per-node 4 examples/torch_multichip.py
    WORLD_SIZE=2 RANK=0 MASTER_ADDR=localhost MASTER_PORT=29500 \
        python3 examples/torch_multichip.py --device cpu     # and RANK=1: gloo

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from ggml_experiments_tpu_torch.models import gru_textgen
from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig
from ggml_experiments_tpu_torch.parallel import (
    AXES,
    DATA_AXIS,
    axis_slice,
    gru_param_specs,
    infer_mesh_shape,
    make_mesh,
    multihost,
    place,
)
from ggml_experiments_tpu_torch.training.gru_trainer import init_train_state, make_train_step

CONFIG = GRUConfig(embed_dim=64, units=128)
LEARNING_RATE = 1e-3
SEQ, DECODE_PROMPT, DECODE_STEPS = 32, 4, 32


def init(device) -> gru_textgen.GRUTextGenParams:
    """The example's model, drawn from seed 0 on the CPU, on ``device``."""
    return gru_textgen.init_params(CONFIG, torch.Generator().manual_seed(0), device=device)


def train_and_decode(params, mesh, batch: int, device):
    """Place ``params`` on ``mesh``, take one Adam step on a seeded
    (batch, SEQ) batch, decode DECODE_STEPS tokens from zero prompts.
    Returns (the kernel's spec, the loss, the decoded tokens)."""
    specs = gru_param_specs(params)
    params = place(params, specs, mesh)
    params, opt_state = init_train_state(params, device=device)
    step = make_train_step(LEARNING_RATE, mesh=mesh)
    rng = np.random.default_rng(0)
    sl = axis_slice(mesh, DATA_AXIS, batch)
    inputs = torch.from_numpy(rng.integers(0, 66, (batch, SEQ)).astype(np.int32)[sl]).to(device)
    targets = torch.from_numpy(rng.integers(0, 66, (batch, SEQ)).astype(np.int32)[sl]).to(device)
    params, _, loss = step(params, opt_state, inputs, targets)
    with torch.no_grad():
        toks = gru_textgen.generate(params, torch.zeros((batch, DECODE_PROMPT), dtype=torch.int32),
                                    torch.full((batch,), DECODE_PROMPT, dtype=torch.int32),
                                    DECODE_STEPS)
    return specs.cell.kernel, float(loss), toks


def main(device=None):
    dev = multihost.initialize(device=device)   # a no-op alone; joins the group under torchrun
    n = multihost.process_count()
    mesh = make_mesh(infer_mesh_shape(n), device_type=dev.type)
    print(f"{n} devices, mesh {dict(zip(AXES, mesh.shape))}")
    batch = max(8, n)
    spec, loss, toks = train_and_decode(init(dev), mesh, batch, dev)
    print("cell.kernel sharding:", spec)
    print("train step loss:", loss)
    print("sharded decode:", tuple(toks.shape))
    multihost.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' without a GPU")
    main(ap.parse_args().device)
