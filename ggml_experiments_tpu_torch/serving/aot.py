"""Ahead-of-time program artifacts: ``torch.export`` of the greedy GRU decode
and of MobileViT feature extraction, frozen at fixed shapes.

A serving host then needs the port's package (for its custom ops and
parameter trees) and a weight file, and traces nothing: the artifact replays
the program frozen at export. On the card the program reaches the
hand-written kernels through their custom ops (``gxt::qmatmul``,
``gxt::flash_mha``, ``gxt::inverted_residual_f32``,
``gxt::transformer_layer_f32``); on the CPU the same ops run their plain
versions.

Artifact container (``.gxa``): ``GXA1`` magic | uint64 header length | JSON
header (kind, shapes, qtype, device, torch version) | the
``torch.export.save`` bytes, zlib-compressed (header ``"blob": "zlib"``):
the decode loop unrolls into some fifty graph nodes a step, whose JSON
(nine MB at 200 steps) compresses some thirty times. The params tree is a
call argument, so one artifact serves any weight file of the same shapes
and qtype: the trees are registered as pytree nodes
(``pytree.register_params``) whose caches are left out, so params an eager
call has used are taken as they are. The example inputs are not saved, so
no weight rides inside the artifact, and neither are the nodes' source
stack traces.

Programs are exported at f32 (the JAX package's ``aot`` exports the same
two functions at their f32 default). f32 on the card means no TF32:
:func:`call_artifact` switches cuDNN's and cuBLAS's TF32 off around the
call, as the eager f32 convolutions do. Artifacts do not cross packages: a
``.gxa`` written by the JAX package (a StableHLO blob, its header naming
``jax``) is refused with a message that says so.
"""

from __future__ import annotations

import contextlib
import io
import json
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import torch

MAGIC = b"GXA1"


def _register() -> None:
    """Import the modules that register the custom ops and the params trees."""
    import ggml_experiments_tpu_torch.models.gru_textgen  # noqa: F401
    import ggml_experiments_tpu_torch.models.mobilevit  # noqa: F401
    import ggml_experiments_tpu_torch.ops.flash_attention  # noqa: F401
    import ggml_experiments_tpu_torch.ops.fused_inverted_residual  # noqa: F401
    import ggml_experiments_tpu_torch.ops.fused_transformer_layer  # noqa: F401
    import ggml_experiments_tpu_torch.quant.qmatmul  # noqa: F401


def save_artifact(path: str, blob: bytes, meta: Dict[str, Any]) -> None:
    """Write the container around ``blob`` (the compressed program)."""
    header = json.dumps({"version": 1, "torch": torch.__version__, "blob": "zlib",
                         **meta}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(blob)


def _read(path: str, with_blob: bool):
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a GXA1 AOT artifact")
        (hlen,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hlen))
        blob = f.read() if with_blob else None
    if "torch" not in meta:
        made_by = "the JAX package (a StableHLO program)" if "jax" in meta else "another tool"
        raise ValueError(f"{path}: this artifact was made by {made_by}; the PyTorch port runs "
                         f"only artifacts that its own aot-export wrote")
    if meta.get("blob") != "zlib":
        raise ValueError(f"{path}: unknown blob encoding {meta.get('blob')!r}")
    return meta, blob


def read_meta(path: str) -> Dict[str, Any]:
    """A ``.gxa`` file's header, without loading its program."""
    return _read(path, False)[0]


def load_artifact(path: str) -> Tuple[Dict[str, Any], "torch.export.ExportedProgram"]:
    """Read a ``.gxa`` file -> (meta dict, ExportedProgram)."""
    _register()
    meta, blob = _read(path, True)
    return meta, torch.export.load(io.BytesIO(zlib.decompress(blob)))


@contextlib.contextmanager
def _full_f32():
    """No TF32 in cuDNN's convolutions nor cuBLAS's products."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def call_artifact(exported: "torch.export.ExportedProgram", *args) -> torch.Tensor:
    """Run an artifact's program on ``args`` (params first), at full f32."""
    with _full_f32(), torch.no_grad():
        return exported.module()(*args)


def _blob(program, args) -> bytes:
    with _full_f32(), torch.no_grad():
        ep = torch.export.export(program, args, strict=False)
    ep._example_inputs = None       # the params would ride along with them
    for node in list(ep.graph.nodes):
        node.meta.pop("stack_trace", None)
        # the dtype checks that eager .to() calls leave behind: no output,
        # and a fifth of a decode step's nodes
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            ep.graph.erase_node(node)
    ep.graph_module.recompile()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return zlib.compress(buf.getvalue(), 6)


class _GRUDecode(torch.nn.Module):
    def __init__(self, total_steps: int):
        super().__init__()
        self.total_steps = total_steps

    def forward(self, params, prompt, lengths):
        from ggml_experiments_tpu_torch.models import gru_textgen

        return gru_textgen.generate(params, prompt, lengths, self.total_steps,
                                    compute_dtype=torch.float32)


class _Features(torch.nn.Module):
    def forward(self, params, images):
        from ggml_experiments_tpu_torch.models.mobilevit import extract_features

        return extract_features(params, images, compute_dtype=torch.float32)


def export_gru_decode(params, *, batch: int, prompt_len: int, total_steps: int,
                      path: Optional[str] = None, qtype: Optional[str] = None) -> bytes:
    """Export greedy batch decode at fixed (batch, prompt_len, total_steps)
    on the params' device: ``(params, prompt i32 (B, P), lengths i32 (B,))
    -> tokens i32 (B, total_steps)``, the port's ``generate`` at f32."""
    _register()
    dev = params.device
    prompt = torch.zeros((batch, prompt_len), dtype=torch.int32, device=dev)
    lengths = torch.ones((batch,), dtype=torch.int32, device=dev)
    blob = _blob(_GRUDecode(total_steps), (params, prompt, lengths))
    if path:
        save_artifact(path, blob, {
            "kind": "gru-decode", "batch": batch, "prompt_len": prompt_len,
            "total_steps": total_steps, "device": dev.type, "qtype": qtype,
        })
    return blob


def export_mobilevit_features(params, *, batch: int, image_size: int,
                              path: Optional[str] = None,
                              qtype: Optional[str] = None) -> bytes:
    """Export feature extraction at a fixed batch on the params' device:
    ``(params, images f32 (B, S, S, 3)) -> features (B, S/32, S/32, C)``."""
    _register()
    dev = params.device
    images = torch.zeros((batch, image_size, image_size, 3), dtype=torch.float32, device=dev)
    blob = _blob(_Features(), (params, images))
    if path:
        save_artifact(path, blob, {
            "kind": "mobilevit-features", "batch": batch, "image_size": image_size,
            "device": dev.type, "qtype": qtype,
        })
    return blob
