"""MobileViT-small feature extractor and classifier (apple/mobilevit-small).

The JAX package's structure and names at the public surface: NHWC
activations, HWIO convolution kernels, in-features-first dense kernels, BN
folded at load, and dataclasses whose fields are the checkpoint key paths
(``conv_stem/kernel``, ``layer_3/transformer/0/attention/wq``, ...). Module
configuration (activation, stride, heads, eps, the kernel routes) is static:
``compare=False`` fields that checkpoints do not store.

Three routes reach the port's hand-written kernels, gated as in the JAX
package:

* ``InvertedResidualParams.fused`` with an expanded width of at least
  ``IR_FUSED_MIN_EXPAND`` (64) -> ``ops.fused_inverted_residual``: at stride
  1 at bf16, or at f32 on a CUDA device (layer_1's block and layer_2's
  blocks 1-2); at stride 2 on a CUDA device only, at bf16 and f32, with
  even H and W and no residual (the four downsamplers: layer_2's block 0
  and the downsampling block of layers 3-5).
  The JAX package routes bf16 at stride 1 only; the CPU keeps that route,
  and its f32 forward is the JAX package's unfused chain;
* ``TransformerLayerParams.fused`` with L a multiple of 8 ->
  ``ops.fused_transformer_layer`` (``TransformerLayerParams.fused_route``):
  at bf16, and at f32 on a CUDA device where the f32 kernels take the
  layer's shape (``f32_layer_takes``, decided from the shape before any
  launch). When every layer of a block takes the route
  and the block's patch count is a multiple of 8, the block folds its
  conv_1x1 into the first layer (``input_proj``) and its LN and
  conv_projection (+BN, SiLU) into the last (``final_ln``,
  ``output_proj``). The JAX package routes bf16 only; the CPU keeps that
  route, and its f32 forward is the JAX package's unfused chain;
* ``AttentionParams.flash`` with L a multiple of 8 -> ``ops.flash_attention``
  (the f32 route where the fused layer does not take it, and bf16 without
  the fused layer).

``flash_attn=None`` / ``fused_layer=None`` / ``fused_ir=None`` at load mean
"on when the parameters live on a CUDA device, off on the CPU" (the JAX
package leaves ``fused_ir`` off; on the H100 it wins at every batch of the
VisionEngine's ladder: ``IR_FUSED_MIN_EXPAND``).

Load-time options: ``conv_dtype`` (convolution kernels rounded through f16,
or stored in bf16), ``stem_space_to_depth`` (``ops.conv.SpaceToDepthStem``)
and ``act_storage`` with ``act_storage_scope`` (conv-stage boundary
activations stored below bf16 on the bf16 path: :func:`_stamp_act_storage`).
``from_named_tensors`` also takes torch tensors that require grad, so that a
loss differentiates through the assembly, BN folding included
(``training/image_task.train_model``).
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device, resolve_dtype
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.attention import AttentionParams, multi_head_attention
from ggml_experiments_tpu_torch.ops.conv import (
    STORE_DTYPES,
    ConvBNAct,
    SpaceToDepthStem,
    space_to_depth_stem,
    static_field,
)
from ggml_experiments_tpu_torch.ops.linear import Weight, linear
from ggml_experiments_tpu_torch.ops.norm import fold_batchnorm, layer_norm
from ggml_experiments_tpu_torch.ops.patches import fold, unfold
from ggml_experiments_tpu_torch.parallel import multihost
from ggml_experiments_tpu_torch.pytree import register_params
from ggml_experiments_tpu_torch.quant.qtensor import quantize

ACT_STORAGE_SCOPES = ("stem", "stem12", "early", "all")


@dataclasses.dataclass(frozen=True)
class MobileViTConfig:
    """apple/mobilevit-small hyper-parameters."""

    num_channels: int = 3
    image_size: int = 256
    patch_size: int = 2
    hidden_sizes: Tuple[int, int, int] = (144, 192, 240)
    neck_hidden_sizes: Tuple[int, ...] = (16, 32, 64, 96, 128, 160, 640)
    num_attention_heads: int = 4
    mlp_ratio: float = 2.0
    expand_ratio: float = 4.0
    conv_kernel_size: int = 3
    layer_norm_eps: float = 1e-5
    num_transformer_layers: Tuple[int, int, int] = (2, 4, 3)
    num_labels: int = 1000  # classifier head (HF MobileViTForImageClassification)


# The fused inverted residual runs from this expanded width on (stride 2 too,
# on a CUDA device): the smallest stride-1 width measured,
# layer_1's. On an NVIDIA H100 80GB HBM3 at 700.00 W
# (tools/torch_gate_sweep.py; PERF.md, "Dispatch gates"), extract_features
# at bf16 with layer_1's block fused too (E >= 64) ran 1.17 / 1.45 / 1.65x
# the unfused forward at B = 8 / 32 / 128, against 1.06 / 1.26 / 1.35x with
# layer_2's blocks alone (E >= 128). At f32 on the same card
# (tools/torch_gate_sweep.py --only ir_f32; PERF.md §6) the f32 kernel beat
# cuDNN's f32 chain 1.49-2.39x a call at both stride-1 blocks and at each B,
# and extract_features at f32 ran 1.11 / 1.23 / 1.25x the unfused forward.
# Stride 2 takes all four downsamplers on a CUDA device: on the same card
# (tools/torch_gate_sweep.py --only ir_s2; PERF.md §6, PR 15) extract_features
# ran 1.31 / 1.34 / 1.47x faster with them at bf16 and 1.18 / 1.23 / 1.23x
# at f32, B = 8 / 32 / 128. The same cells' CUDA-graph replays (the card's
# time alone, where the host clock's turns spread at B = 8 and 32), on the
# stride-2 kernel's tile design, put the route at all four downsamplers
# fastest or tied at every B and dtype, ahead of leaving layer_5's block
# (E = 512) or layers 4-5's unfused (PERF.md §6).
IR_FUSED_MIN_EXPAND = 64


@dataclasses.dataclass
class InvertedResidualParams:
    """MobileNetV2 block: expand 1x1 -> depthwise 3x3 (stride s) -> reduce 1x1."""

    expand_1x1: ConvBNAct
    conv_3x3: ConvBNAct
    reduce_1x1: ConvBNAct
    use_residual: bool = static_field(False)
    fused: bool = static_field(False)

    def fused_route(self, compute_dtype, device=None, hw=None) -> bool:
        """Whether a call at ``compute_dtype`` on ``device`` (on an input of
        ``hw`` = (H, W), None: not checked) runs the fused kernel: E >=
        IR_FUSED_MIN_EXPAND (where the kernels win), and at stride 1 bf16, or
        f32 on a CUDA device; at stride 2 (bf16 and f32) a CUDA device, even
        H and W and no residual (what the stride-2 kernel takes; the CPU
        keeps the JAX model's route, stride 1 only). On a CUDA device each
        kernel also takes only the widths whose plan or tile fits a block's
        shared memory: the bf16 stride-1 strip or wide kernel
        (``ir_bf16_takes``), the f32 stride-1 and the stride-2 kernels
        (``ir_tc_takes``); the rest runs the unfused chain."""
        from ggml_experiments_tpu_torch.ops.fused_inverted_residual import (
            ir_bf16_takes,
            ir_tc_takes,
        )

        cd = resolve_dtype(compute_dtype)
        on_card = device is not None and torch.device(device).type == "cuda"
        c, e = self.expand_1x1.kernel.shape[-2:]
        if not self.fused or e < IR_FUSED_MIN_EXPAND:
            return False
        cout = self.reduce_1x1.kernel.shape[-1]
        if self.conv_3x3.stride == 2:
            return (on_card and not self.use_residual
                    and (hw is None or (hw[0] % 2 == 0 and hw[1] % 2 == 0))
                    and ir_tc_takes(2, c, e, cout, cd))
        if self.conv_3x3.stride != 1:
            return False
        if cd == torch.bfloat16:
            return not on_card or ir_bf16_takes(c, e, cout)
        return cd == torch.float32 and on_card and ir_tc_takes(1, c, e, cout, cd)

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        cd = resolve_dtype(compute_dtype)
        if self.fused_route(cd, x.device, x.shape[1:3]):
            from ggml_experiments_tpu_torch.ops.fused_inverted_residual import (
                inverted_residual_fused,
            )

            # an input stored below bf16 (ConvBNAct.store) widens at the
            # kernel's boundary; the kernel's output stays in the compute dtype
            return inverted_residual_fused(self, x.to(cd), compute_dtype=cd)
        kw = dict(compute_dtype=cd)
        y = self.reduce_1x1(self.conv_3x3(self.expand_1x1(x, **kw), **kw), **kw)
        if not self.use_residual:
            return y
        # added in the compute dtype, then stored as wide as the block's output
        out = x.to(cd) + y.to(cd)
        return out.to(y.dtype) if y.dtype != out.dtype else out


@dataclasses.dataclass
class TransformerLayerParams:
    """Pre-LN ViT encoder layer with a SiLU MLP."""

    ln_before_gamma: torch.Tensor
    ln_before_beta: torch.Tensor
    attention: AttentionParams
    ln_after_gamma: torch.Tensor
    ln_after_beta: torch.Tensor
    intermediate_kernel: Weight   # (C, mlp_ratio*C)
    intermediate_bias: torch.Tensor
    output_kernel: Weight         # (mlp_ratio*C, C)
    output_bias: torch.Tensor
    eps: float = static_field(1e-5)
    fused: bool = static_field(False)

    def fused_route(self, compute_dtype, device=None, l: Optional[int] = None,
                    cin: Optional[int] = None) -> bool:
        """Whether a call at ``compute_dtype`` on ``device`` over sequences of
        ``l`` tokens (None: not checked), whose input has ``cin`` channels
        where the block folds its conv_1x1 in, runs the fused layer: ``fused``
        set and L a multiple of 8; bf16 anywhere (the JAX model's route); f32
        on a CUDA device only, where the f32 kernels take the shape. On an
        NVIDIA H100 80GB HBM3 at 700.00 W (tools/torch_gate_sweep.py --only
        layer_f32; PERF.md §6) extract_features at f32 ran 2.72 /
        1.24 / 1.23x faster on the f32 route than on the unfused chain with
        flash attention at B = 8 / 32 / 128. On a CUDA device bf16 too takes
        only the widths its kernels take (``bf16_layer_takes``: an even head
        width up to 64, a row-tile layout that fits a block); the rest runs
        the unfused chain."""
        cd = resolve_dtype(compute_dtype)
        if not self.fused or (l is not None and l % 8):
            return False
        on_card = device is not None and torch.device(device).type == "cuda"
        c = self.attention.wq.shape[0]
        if cd == torch.bfloat16:
            if not on_card:
                return True
            from ggml_experiments_tpu_torch.ops.fused_transformer_layer import bf16_layer_takes

            return bf16_layer_takes(c if cin is None else cin, c, self.attention.num_heads,
                                    in_proj=cin is not None)
        if cd != torch.float32 or not on_card:
            return False
        if l is None:
            return True
        from ggml_experiments_tpu_torch.ops.fused_transformer_layer import f32_layer_takes

        return f32_layer_takes(l, c if cin is None else cin, c, self.attention.num_heads,
                               self.intermediate_kernel.shape[-1], in_proj=cin is not None)

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        cd = resolve_dtype(compute_dtype)
        if self.fused_route(cd, x.device, x.shape[-2]):
            from ggml_experiments_tpu_torch.ops.fused_transformer_layer import (
                fused_transformer_layer,
            )

            return fused_transformer_layer(self, x, compute_dtype=cd)
        kw = dict(compute_dtype=cd)
        attn_in = layer_norm(x, self.ln_before_gamma, self.ln_before_beta, eps=self.eps)
        x = x + multi_head_attention(self.attention, attn_in, **kw)
        y = layer_norm(x, self.ln_after_gamma, self.ln_after_beta, eps=self.eps)
        y = silu(linear(y, self.intermediate_kernel, self.intermediate_bias, **kw))
        y = linear(y, self.output_kernel, self.output_bias, **kw)
        return x + y


@dataclasses.dataclass
class MobileViTBlockParams:
    """MobileViT block: local convs + unfold -> transformer -> fold + fusion."""

    downsampling: InvertedResidualParams
    conv_kxk: ConvBNAct
    conv_1x1: ConvBNAct            # no BN, no activation
    transformer: Tuple[TransformerLayerParams, ...]
    ln_gamma: torch.Tensor
    ln_beta: torch.Tensor
    conv_projection: ConvBNAct
    fusion: ConvBNAct
    patch_size: int = static_field(2)
    eps: float = static_field(1e-5)

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        cd = resolve_dtype(compute_dtype)
        kw = dict(compute_dtype=cd)
        x = self.downsampling(x, **kw)
        residual = x
        k = self.conv_kxk(x, **kw)
        h, w = k.shape[1], k.shape[2]
        n_patches = (h // self.patch_size) * (w // self.patch_size)
        all_fused = (len(self.transformer) > 0
                     and all(layer.fused_route(cd, k.device, n_patches,
                                               cin=k.shape[-1] if i == 0 else None)
                             for i, layer in enumerate(self.transformer)))
        if all_fused:
            # conv_1x1 and conv_projection are pointwise, so they commute with
            # unfold/fold and ride inside the first/last layer's kernel
            from ggml_experiments_tpu_torch.ops.fused_transformer_layer import (
                fused_transformer_layer,
            )

            t = unfold(k, self.patch_size)
            n = len(self.transformer)
            cin = k.shape[-1]
            proj_bn = self.conv_projection.bn
            for i, layer in enumerate(self.transformer):
                extra = {}
                if i == 0:
                    extra["input_proj"] = self.conv_1x1.kernel.reshape(cin, -1)
                if i == n - 1:
                    extra["final_ln"] = (self.ln_gamma, self.ln_beta)
                    extra["final_ln_eps"] = self.eps
                    pk = self.conv_projection.kernel
                    cout = pk.shape[-1]
                    extra["output_proj"] = (
                        pk.reshape(pk.shape[-2], cout),
                        proj_bn.scale if proj_bn is not None
                        else torch.ones(cout, device=pk.device),
                        proj_bn.bias if proj_bn is not None
                        else torch.zeros(cout, device=pk.device),
                        self.conv_projection.activation,
                    )
                t = fused_transformer_layer(layer, t, compute_dtype=cd, **extra)
            f = fold(t, self.patch_size, h, w)
        else:
            f = self.conv_1x1(k, **kw)
            t = unfold(f, self.patch_size)
            for layer in self.transformer:
                t = layer(t, **kw)
            t = layer_norm(t, self.ln_gamma, self.ln_beta, eps=self.eps)
            f = fold(t, self.patch_size, h, w)
            f = self.conv_projection(f, **kw)
        return self.fusion(torch.cat([residual.to(cd), f.to(cd)], dim=-1), **kw)


@dataclasses.dataclass
class MobileViTParams:
    conv_stem: Union[ConvBNAct, SpaceToDepthStem]
    layer_1: Tuple[InvertedResidualParams, ...]
    layer_2: Tuple[InvertedResidualParams, ...]
    layer_3: MobileViTBlockParams
    layer_4: MobileViTBlockParams
    layer_5: MobileViTBlockParams
    conv_1x1_exp: ConvBNAct
    classifier_kernel: Optional[Weight] = None   # (640, num_labels)
    classifier_bias: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.conv_stem.kernel.device


for _cls in (InvertedResidualParams, TransformerLayerParams, MobileViTBlockParams,
             MobileViTParams):
    register_params(_cls)


def extract_features(params: MobileViTParams, images: torch.Tensor, *,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """images (B, H, W, 3) float32 -> features (B, H/32, W/32, 640) float32.
    ``bfloat16`` computes every product in bf16 with f32 sums and stores every
    activation in bf16; the features come back as f32."""
    cd = resolve_dtype(compute_dtype)
    kw = dict(compute_dtype=cd)
    x = images.to(params.device).to(cd)
    x = params.conv_stem(x, **kw)
    for blk in params.layer_1:
        x = blk(x, **kw)
    for blk in params.layer_2:
        x = blk(x, **kw)
    x = params.layer_3(x, **kw)
    x = params.layer_4(x, **kw)
    x = params.layer_5(x, **kw)
    return params.conv_1x1_exp(x, **kw).float()


def extract_features_data_parallel(params: MobileViTParams, images, *,
                                   compute_dtype=torch.float32) -> torch.Tensor:
    """:func:`extract_features` over every process of the default group:
    each runs its ``host_local_batch_slice`` of the global batch ``images``
    on its own device (whole images, so the fused layer, flash attention and
    the fused inverted residual run unchanged on the local batch) and the
    features are all-gathered into the global batch. Single-process: the
    plain forward."""
    images = torch.as_tensor(images)
    local = images[multihost.host_local_batch_slice(images.shape[0])]
    return multihost.global_from_host_data(
        extract_features(params, local, compute_dtype=compute_dtype))


def classify(params: MobileViTParams, images: torch.Tensor, *,
             compute_dtype=torch.float32) -> torch.Tensor:
    """Logits: global average pool + dense (HF MobileViTForImageClassification)."""
    if params.classifier_kernel is None:
        raise ValueError("params have no classifier head")
    cd = resolve_dtype(compute_dtype)
    pooled = extract_features(params, images, compute_dtype=cd).mean(dim=(1, 2))
    return linear(pooled, params.classifier_kernel, params.classifier_bias,
                  compute_dtype=cd).float()


# ---------------------------------------------------------------------------
# Loading from the reference's named-tensor format (TF variable paths)
# ---------------------------------------------------------------------------

_PREFIX = "tf_mobile_vi_t_model/mobilevit"
_CLASSIFIER_KEYS = (
    "classifier/kernel:0",
    "tf_mobile_vi_t_for_image_classification/classifier/kernel:0",
)


def _detect_prefix(tensors) -> str:
    """TFMobileViTModel exports under tf_mobile_vi_t_model/mobilevit/..., the
    classification export under its own root."""
    for key in tensors:
        if "/mobilevit/conv_stem/" in key:
            return key.split("/mobilevit/")[0] + "/mobilevit"
    return _PREFIX


def _find_classifier_key(tensors):
    for cand in _CLASSIFIER_KEYS:
        if cand in tensors:
            return cand
    return None


class _TensorMap:
    """Name-map access with did-you-mean errors and use tracking."""

    def __init__(self, tensors: Dict[str, np.ndarray]):
        self.tensors = tensors
        self.used = set()

    def get(self, name: str) -> np.ndarray:
        if name not in self.tensors:
            close = difflib.get_close_matches(name, self.tensors.keys(), n=2)
            raise KeyError(f"missing weight {name!r}; closest: {close}")
        self.used.add(name)
        return self.tensors[name]

    def unused(self):
        return sorted(set(self.tensors) - self.used)


class _Builder:
    """Turns named arrays into the port's parameter dataclasses on one device.
    Numpy arrays are copied to the CPU in f32, BN folded there, then moved;
    torch tensors are used as they are (autograd included), BN folded on
    their own device."""

    def __init__(self, tm: _TensorMap, dev: torch.device, conv_dtype: Optional[str],
                 qtype: Optional[str]):
        self.tm, self.dev, self.conv_dtype, self.qtype = tm, dev, conv_dtype, qtype

    def f32(self, name: str) -> torch.Tensor:
        a = self.tm.get(name)
        if isinstance(a, torch.Tensor):
            return a.float()
        return torch.from_numpy(np.array(a, np.float32))

    def t(self, name: str) -> torch.Tensor:
        return self.f32(name).to(self.dev)

    def conv(self, path: str, *, stride: int = 1, use_bn: bool = True,
             activation: Optional[str] = "silu", depthwise: bool = False,
             eps: float = 1e-5) -> ConvBNAct:
        kernel = self.f32(f"{path}/convolution/kernel:0")
        if self.conv_dtype == "float16":
            # the reference loader's f16 policy for names containing "convolution"
            kernel = kernel.half().float()
        elif self.conv_dtype == "bfloat16":
            kernel = kernel.to(torch.bfloat16)   # stored in bf16: half the bytes
        bn = None
        if use_bn:
            stats = [self.f32(f"{path}/normalization/{n}:0")
                     for n in ("gamma", "beta", "moving_mean", "moving_variance")]
            folded = fold_batchnorm(*stats, eps=eps)
            folded.scale, folded.bias = folded.scale.to(self.dev), folded.bias.to(self.dev)
            bn = folded
        return ConvBNAct(kernel=kernel.to(self.dev), bn=bn, activation=activation or "none",
                         stride=stride, depthwise=depthwise)

    def weight(self, name: str) -> Weight:
        if self.qtype:
            return quantize(self.tm.get(name), self.qtype, device=self.dev)
        return self.t(name)

    def inverted(self, path: str, in_ch: int, out_ch: int, stride: int,
                 fused: bool, residual: Optional[bool] = None) -> InvertedResidualParams:
        return InvertedResidualParams(
            expand_1x1=self.conv(f"{path}/expand_1x1"),
            conv_3x3=self.conv(f"{path}/conv_3x3", stride=stride, depthwise=True),
            reduce_1x1=self.conv(f"{path}/reduce_1x1", activation=None),
            use_residual=(stride == 1 and in_ch == out_ch) if residual is None else residual,
            fused=fused,
        )

    def transformer_layer(self, path: str, num_heads: int, eps: float, flash: bool,
                          fused: bool) -> TransformerLayerParams:
        att = f"{path}/attention"
        return TransformerLayerParams(
            ln_before_gamma=self.t(f"{path}/layernorm_before/gamma:0"),
            ln_before_beta=self.t(f"{path}/layernorm_before/beta:0"),
            attention=AttentionParams(
                wq=self.weight(f"{att}/attention/query/kernel:0"),
                bq=self.t(f"{att}/attention/query/bias:0"),
                wk=self.weight(f"{att}/attention/key/kernel:0"),
                bk=self.t(f"{att}/attention/key/bias:0"),
                wv=self.weight(f"{att}/attention/value/kernel:0"),
                bv=self.t(f"{att}/attention/value/bias:0"),
                wo=self.weight(f"{att}/output/dense/kernel:0"),
                bo=self.t(f"{att}/output/dense/bias:0"),
                num_heads=num_heads, flash=flash,
            ),
            ln_after_gamma=self.t(f"{path}/layernorm_after/gamma:0"),
            ln_after_beta=self.t(f"{path}/layernorm_after/beta:0"),
            intermediate_kernel=self.weight(f"{path}/intermediate/dense/kernel:0"),
            intermediate_bias=self.t(f"{path}/intermediate/dense/bias:0"),
            output_kernel=self.weight(f"{path}/output/dense/kernel:0"),
            output_bias=self.t(f"{path}/output/dense/bias:0"),
            eps=eps, fused=fused,
        )

    def vit_block(self, path: str, in_ch: int, out_ch: int, n_layers: int,
                  config: MobileViTConfig, fused_ir: bool, flash: bool,
                  fused_layer: bool) -> MobileViTBlockParams:
        eps = config.layer_norm_eps
        return MobileViTBlockParams(
            downsampling=self.inverted(f"{path}/downsampling_layer", in_ch, out_ch, 2, fused_ir,
                                       residual=False),
            conv_kxk=self.conv(f"{path}/conv_kxk"),
            conv_1x1=self.conv(f"{path}/conv_1x1", use_bn=False, activation=None),
            transformer=tuple(
                self.transformer_layer(f"{path}/transformer/layer.{i}",
                                       config.num_attention_heads, eps, flash, fused_layer)
                for i in range(n_layers)),
            ln_gamma=self.t(f"{path}/layernorm/gamma:0"),
            ln_beta=self.t(f"{path}/layernorm/beta:0"),
            conv_projection=self.conv(f"{path}/conv_projection"),
            fusion=self.conv(f"{path}/fusion"),
            patch_size=config.patch_size, eps=eps,
        )


def from_named_tensors(
    tensors: Dict[str, np.ndarray],
    config: MobileViTConfig = MobileViTConfig(),
    *,
    conv_dtype: Optional[str] = None,
    qtype: Optional[str] = None,
    strict: bool = False,
    stem_space_to_depth: bool = False,
    fused_ir: Optional[bool] = None,
    flash_attn: Optional[bool] = None,
    fused_layer: Optional[bool] = None,
    act_storage: Optional[str] = None,
    act_storage_scope: str = "early",
    device: DeviceLike = None,
) -> MobileViTParams:
    """Assemble the model from a ``weight.ggml``-style name map (numpy arrays,
    or torch tensors, which keep their autograd).

    ``conv_dtype='float16'`` rounds convolution kernels through f16 (the
    reference loader's policy), ``'bfloat16'`` stores them in bf16;
    ``qtype`` block-quantizes every transformer dense kernel and the
    classifier; ``stem_space_to_depth`` rewrites the stem
    (``ops.conv.SpaceToDepthStem``); ``act_storage`` ('f8_e5m2' / 'f8_e4m3' /
    'bfloat16') stores the conv-stage boundary activations of the bf16 path
    at that dtype, as deep as ``act_storage_scope`` says
    (:func:`_stamp_act_storage`); ``fused_ir``, ``flash_attn`` and
    ``fused_layer`` pick the kernel routes (module docstring). The root name
    prefix is detected (model or classification export)."""
    if conv_dtype not in (None, "float16", "bfloat16"):
        raise ValueError(f"conv_dtype must be None, 'float16' or 'bfloat16', got {conv_dtype!r}")
    dev = resolve_device(device)
    if flash_attn is None:
        flash_attn = dev.type == "cuda"
    if fused_layer is None:
        fused_layer = dev.type == "cuda"
    if fused_ir is None:
        fused_ir = dev.type == "cuda"
    tm = _TensorMap(tensors)
    bld = _Builder(tm, dev, conv_dtype, qtype)
    prefix = _detect_prefix(tensors)
    neck = config.neck_hidden_sizes
    enc = f"{prefix}/encoder"

    def mobile_net_layer(idx: int, in_ch: int, out_ch: int, stride: int, stages: int):
        blocks = []
        for i in range(stages):
            blocks.append(bld.inverted(f"{enc}/layer.{idx}/layer.{i}", in_ch, out_ch,
                                       stride if i == 0 else 1, fused_ir))
            in_ch = out_ch
        return tuple(blocks)

    def vit(idx: int):
        return bld.vit_block(f"{enc}/layer.{idx}", neck[idx], neck[idx + 1],
                             config.num_transformer_layers[idx - 2], config, fused_ir,
                             flash_attn, fused_layer)

    params = MobileViTParams(
        conv_stem=bld.conv(f"{prefix}/conv_stem", stride=2),
        layer_1=mobile_net_layer(0, neck[0], neck[1], 1, 1),
        layer_2=mobile_net_layer(1, neck[1], neck[2], 2, 3),
        layer_3=vit(2),
        layer_4=vit(3),
        layer_5=vit(4),
        conv_1x1_exp=bld.conv(f"{prefix}/conv_1x1_exp"),
    )
    if stem_space_to_depth:
        params.conv_stem = space_to_depth_stem(params.conv_stem)
    cls_key = _find_classifier_key(tensors)
    if cls_key:
        params.classifier_kernel = bld.weight(cls_key)
        params.classifier_bias = bld.t(cls_key.replace("kernel", "bias"))
    if strict and tm.unused():
        raise ValueError(f"unused weights in file: {tm.unused()[:10]} ...")
    if act_storage is not None:
        params = _stamp_act_storage(params, act_storage, scope=act_storage_scope)
    return params


def _stamp_act_storage(params: MobileViTParams, store: str,
                       scope: str = "early") -> MobileViTParams:
    """The params with a storage policy on the conv stages' outputs.

    ``scope`` picks how deep it reaches (narrower: fewer bytes saved, less
    feature noise):

    * ``'stem'``: conv_stem and layer_1;
    * ``'stem12'``: and layer_2's inverted residuals;
    * ``'early'`` (default): and layer_3's downsampler;
    * ``'all'``: and the later downsamplers and each block's conv_projection
      and fusion.

    The boundaries feeding the transformer layers (conv_kxk, conv_1x1) and
    the f32 features (conv_1x1_exp) always stay at the compute dtype."""
    if store not in STORE_DTYPES:
        raise ValueError(f"unknown act_storage {store!r}; one of {sorted(STORE_DTYPES)}")
    if scope not in ACT_STORAGE_SCOPES:
        raise ValueError(f"unknown act_storage scope {scope!r}; one of {ACT_STORAGE_SCOPES}")
    rep = dataclasses.replace

    def conv(c):
        return rep(c, store=store)

    def ir(blk):
        return rep(blk, expand_1x1=conv(blk.expand_1x1), conv_3x3=conv(blk.conv_3x3),
                   reduce_1x1=conv(blk.reduce_1x1))

    def vit(blk, down_only):
        if down_only:
            return rep(blk, downsampling=ir(blk.downsampling))
        return rep(blk, downsampling=ir(blk.downsampling),
                   conv_projection=conv(blk.conv_projection), fusion=conv(blk.fusion))

    out = rep(params, conv_stem=conv(params.conv_stem),
              layer_1=tuple(ir(b) for b in params.layer_1))
    if scope == "stem":
        return out
    out = rep(out, layer_2=tuple(ir(b) for b in params.layer_2))
    if scope == "stem12":
        return out
    out = rep(out, layer_3=vit(params.layer_3, down_only=scope == "early"))
    if scope == "all":
        out = rep(out, layer_4=vit(params.layer_4, down_only=False),
                  layer_5=vit(params.layer_5, down_only=False))
    return out


def infer_config(tensors: Dict[str, np.ndarray], *, image_size: int = 256,
                 num_attention_heads: int = 4) -> MobileViTConfig:
    """The architecture read off a name map's shapes. ``image_size`` and
    ``num_attention_heads`` are not recoverable from weights and stay
    caller-provided."""
    prefix = _detect_prefix(tensors)
    enc = f"{prefix}/encoder"
    tm = _TensorMap(tensors)

    def oc(path):
        return tm.get(f"{path}/convolution/kernel:0").shape[-1]

    stem = tm.get(f"{prefix}/conv_stem/convolution/kernel:0")
    neck = [
        oc(f"{prefix}/conv_stem"),
        oc(f"{enc}/layer.0/layer.0/reduce_1x1"),
        oc(f"{enc}/layer.1/layer.0/reduce_1x1"),
        oc(f"{enc}/layer.2/downsampling_layer/reduce_1x1"),
        oc(f"{enc}/layer.3/downsampling_layer/reduce_1x1"),
        oc(f"{enc}/layer.4/downsampling_layer/reduce_1x1"),
        oc(f"{prefix}/conv_1x1_exp"),
    ]
    hidden, n_layers = [], []
    for li in (2, 3, 4):
        hidden.append(oc(f"{enc}/layer.{li}/conv_1x1"))
        n = 0
        while f"{enc}/layer.{li}/transformer/layer.{n}/intermediate/dense/kernel:0" in tensors:
            n += 1
        n_layers.append(n)
    inter = tm.get(f"{enc}/layer.2/transformer/layer.0/intermediate/dense/kernel:0")
    expand = tm.get(f"{enc}/layer.0/layer.0/expand_1x1/convolution/kernel:0")
    kxk = tm.get(f"{enc}/layer.2/conv_kxk/convolution/kernel:0")
    cls_key = _find_classifier_key(tensors)
    num_labels = tensors[cls_key].shape[-1] if cls_key else MobileViTConfig.num_labels
    return MobileViTConfig(
        num_channels=stem.shape[2],
        image_size=image_size,
        hidden_sizes=tuple(hidden),
        neck_hidden_sizes=tuple(neck),
        num_attention_heads=num_attention_heads,
        mlp_ratio=inter.shape[1] / inter.shape[0],
        expand_ratio=expand.shape[-1] / expand.shape[2],
        conv_kernel_size=kxk.shape[0],
        num_transformer_layers=tuple(n_layers),
        num_labels=num_labels,
    )


def random_named_tensors(config: MobileViTConfig = MobileViTConfig(), *, seed: int = 0,
                         classifier: bool = False) -> Dict[str, np.ndarray]:
    """A full random weight map with the converter's TF variable names and
    shapes, from a numpy seed (the same arrays as the JAX package's)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    def conv(path, kh, kw, ic, oc, bn=True):
        fan_in = kh * kw * ic
        out[f"{path}/convolution/kernel:0"] = (
            rng.standard_normal((kh, kw, ic, oc)) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if bn:
            out[f"{path}/normalization/gamma:0"] = np.ones(oc, np.float32)
            out[f"{path}/normalization/beta:0"] = np.zeros(oc, np.float32)
            out[f"{path}/normalization/moving_mean:0"] = np.zeros(oc, np.float32)
            out[f"{path}/normalization/moving_variance:0"] = np.ones(oc, np.float32)

    def dense(path, k, n):
        lim = np.sqrt(6.0 / (k + n))
        out[f"{path}/kernel:0"] = rng.uniform(-lim, lim, (k, n)).astype(np.float32)
        out[f"{path}/bias:0"] = np.zeros(n, np.float32)

    def inverted(path, in_ch, out_ch, expand):
        conv(f"{path}/expand_1x1", 1, 1, in_ch, expand)
        conv(f"{path}/conv_3x3", 3, 3, 1, expand)
        conv(f"{path}/reduce_1x1", 1, 1, expand, out_ch)

    neck = config.neck_hidden_sizes
    er = int(config.expand_ratio)
    enc = f"{_PREFIX}/encoder"
    conv(f"{_PREFIX}/conv_stem", 3, 3, config.num_channels, neck[0])
    inverted(f"{enc}/layer.0/layer.0", neck[0], neck[1], neck[0] * er)
    in_ch = neck[1]
    for i in range(3):
        inverted(f"{enc}/layer.1/layer.{i}", in_ch, neck[2], in_ch * er)
        in_ch = neck[2]
    for li, (in_c, out_c, hidden, n_layers) in enumerate(
            zip(neck[2:5], neck[3:6], config.hidden_sizes, config.num_transformer_layers)):
        path = f"{enc}/layer.{li + 2}"
        inverted(f"{path}/downsampling_layer", in_c, out_c, in_c * er)
        conv(f"{path}/conv_kxk", config.conv_kernel_size, config.conv_kernel_size, out_c, out_c)
        conv(f"{path}/conv_1x1", 1, 1, out_c, hidden, bn=False)
        for i in range(n_layers):
            tl = f"{path}/transformer/layer.{i}"
            for nm in ("attention/attention/query", "attention/attention/key",
                       "attention/attention/value", "attention/output/dense"):
                dense(f"{tl}/{nm}", hidden, hidden)
            dense(f"{tl}/intermediate/dense", hidden, int(hidden * config.mlp_ratio))
            dense(f"{tl}/output/dense", int(hidden * config.mlp_ratio), hidden)
            for ln in ("layernorm_before", "layernorm_after"):
                out[f"{tl}/{ln}/gamma:0"] = np.ones(hidden, np.float32)
                out[f"{tl}/{ln}/beta:0"] = np.zeros(hidden, np.float32)
        out[f"{path}/layernorm/gamma:0"] = np.ones(hidden, np.float32)
        out[f"{path}/layernorm/beta:0"] = np.zeros(hidden, np.float32)
        conv(f"{path}/conv_projection", 1, 1, hidden, out_c)
        conv(f"{path}/fusion", config.conv_kernel_size, config.conv_kernel_size, 2 * out_c, out_c)
    conv(f"{_PREFIX}/conv_1x1_exp", 1, 1, neck[5], neck[6])
    if classifier:
        dense("classifier", neck[6], config.num_labels)
    return out


def config_from_meta(meta: Dict) -> MobileViTConfig:
    """The config a MobileViT ``.gxt`` file's meta header records."""
    if meta.get("kind") != "mobilevit":
        raise ValueError(f"not a MobileViT .gxt checkpoint (meta kind {meta.get('kind')!r})")
    mcfg = dict(meta["config"])
    for key in ("hidden_sizes", "neck_hidden_sizes", "num_transformer_layers"):
        mcfg[key] = tuple(mcfg[key])
    return MobileViTConfig(**mcfg)


def load_mobilevit(path: str, config: Optional[MobileViTConfig] = None, *,
                   device: DeviceLike = None, **kw) -> MobileViTParams:
    """Load a ``weight.ggml`` named-tensor file or a ``.gxt`` params checkpoint.

    For ``weight.ggml`` with ``config=None`` the architecture is inferred from
    the shapes. For ``.gxt`` the config comes from the file's meta header and
    the stored leaves (including mixed-format quantized weights, as stored)
    load into a template built with the caller's options (routes,
    ``act_storage``); ``stem_space_to_depth`` rewrites the loaded stem."""
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors

    dev = resolve_device(device)
    if path.endswith(".gxt"):
        meta = checkpoint.read_meta(path)
        try:
            config = config or config_from_meta(meta)
        except ValueError as ex:
            raise ValueError(f"{path}: {ex}") from None
        kw.pop("qtype", None)  # the checkpoint's quantization is what it stored
        s2d = kw.pop("stem_space_to_depth", False)
        template = from_named_tensors(
            random_named_tensors(config, seed=0, classifier=meta.get("classifier", True)),
            config, qtype=None, device=dev, **kw)
        params = checkpoint.load_into(path, template, device=dev)
        if s2d and not isinstance(params.conv_stem, SpaceToDepthStem):
            params.conv_stem = space_to_depth_stem(params.conv_stem)
        return params
    named = read_named_tensors(path)
    if config is None:
        config = infer_config(named)
    return from_named_tensors(named, config, device=dev, **kw)
