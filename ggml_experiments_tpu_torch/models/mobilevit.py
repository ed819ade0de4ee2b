"""MobileViT-small feature extractor and classifier (apple/mobilevit-small).

The JAX package's structure and names at the public surface: NHWC
activations, HWIO convolution kernels, in-features-first dense kernels, BN
folded at load, and dataclasses whose fields are the checkpoint key paths
(``conv_stem/kernel``, ``layer_3/transformer/0/attention/wq``, ...). Module
configuration (activation, stride, heads, eps, the kernel routes) is static:
``compare=False`` fields that checkpoints do not store.

Three routes reach the port's hand-written kernels, gated as in the JAX
package:

* ``InvertedResidualParams.fused`` at bf16, stride 1 and an expanded width
  of at least 128 -> ``ops.fused_inverted_residual`` (layer_2 blocks 1-2);
* ``TransformerLayerParams.fused`` at bf16 with L a multiple of 8 ->
  ``ops.fused_transformer_layer``; when every layer of a block is fused and
  the block's patch count is a multiple of 8, the block folds its conv_1x1
  into the first layer (``input_proj``) and its LN and conv_projection (+BN,
  SiLU) into the last (``final_ln``, ``output_proj``);
* ``AttentionParams.flash`` with L a multiple of 8 -> ``ops.flash_attention``
  (the f32 route, and bf16 without the fused layer).

``flash_attn=None`` / ``fused_layer=None`` at load mean "on when the
parameters live on a CUDA device, off on the CPU".
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device, resolve_dtype
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.attention import AttentionParams, multi_head_attention
from ggml_experiments_tpu_torch.ops.conv import ConvBNAct, static_field
from ggml_experiments_tpu_torch.ops.linear import Weight, linear
from ggml_experiments_tpu_torch.ops.norm import fold_batchnorm, layer_norm
from ggml_experiments_tpu_torch.ops.patches import fold, unfold
from ggml_experiments_tpu_torch.quant.qtensor import quantize

UNPORTED = "is not ported (ROADMAP.md, 'Port: still to port', item 6: MobileViT)"


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


@dataclasses.dataclass
class InvertedResidualParams:
    """MobileNetV2 block: expand 1x1 -> depthwise 3x3 (stride s) -> reduce 1x1."""

    expand_1x1: ConvBNAct
    conv_3x3: ConvBNAct
    reduce_1x1: ConvBNAct
    use_residual: bool = static_field(False)
    fused: bool = static_field(False)

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        cd = resolve_dtype(compute_dtype)
        if (self.fused and cd == torch.bfloat16 and self.conv_3x3.stride == 1
                and self.expand_1x1.kernel.shape[-1] >= 128):
            from ggml_experiments_tpu_torch.ops.fused_inverted_residual import (
                inverted_residual_fused,
            )

            return inverted_residual_fused(self, x.to(cd), compute_dtype=cd)
        kw = dict(compute_dtype=cd)
        y = self.reduce_1x1(self.conv_3x3(self.expand_1x1(x, **kw), **kw), **kw)
        if not self.use_residual:
            return y
        return x.to(cd) + y.to(cd)


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

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        cd = resolve_dtype(compute_dtype)
        if self.fused and cd == torch.bfloat16 and x.shape[-2] % 8 == 0:
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
        all_fused = (len(self.transformer) > 0
                     and all(layer.fused for layer in self.transformer)
                     and cd == torch.bfloat16
                     and (h // self.patch_size) * (w // self.patch_size) % 8 == 0)
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
    conv_stem: ConvBNAct
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
    """Turns named numpy arrays into the port's parameter dataclasses on one
    device: BN folded in f32 on the CPU, then moved."""

    def __init__(self, tm: _TensorMap, dev: torch.device, conv_dtype: Optional[str],
                 qtype: Optional[str]):
        self.tm, self.dev, self.conv_dtype, self.qtype = tm, dev, conv_dtype, qtype

    def t(self, name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(self.tm.get(name), np.float32)).to(self.dev)

    def conv(self, path: str, *, stride: int = 1, use_bn: bool = True,
             activation: Optional[str] = "silu", depthwise: bool = False,
             eps: float = 1e-5) -> ConvBNAct:
        kernel = np.array(self.tm.get(f"{path}/convolution/kernel:0"), np.float32)
        if self.conv_dtype == "float16":
            # the reference loader's f16 policy for names containing "convolution"
            kernel = kernel.astype(np.float16).astype(np.float32)
        bn = None
        if use_bn:
            stats = [torch.from_numpy(np.array(self.tm.get(f"{path}/normalization/{n}:0"),
                                               np.float32))
                     for n in ("gamma", "beta", "moving_mean", "moving_variance")]
            folded = fold_batchnorm(*stats, eps=eps)
            folded.scale, folded.bias = folded.scale.to(self.dev), folded.bias.to(self.dev)
            bn = folded
        return ConvBNAct(kernel=torch.from_numpy(kernel).to(self.dev), bn=bn,
                         activation=activation or "none", stride=stride, depthwise=depthwise)

    def weight(self, name: str) -> Weight:
        arr = np.array(self.tm.get(name), np.float32)
        if self.qtype:
            return quantize(arr, self.qtype, device=self.dev)
        return torch.from_numpy(arr).to(self.dev)

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
    fused_ir: bool = False,
    flash_attn: Optional[bool] = None,
    fused_layer: Optional[bool] = None,
    act_storage: Optional[str] = None,
    device: DeviceLike = None,
) -> MobileViTParams:
    """Assemble the model from a ``weight.ggml``-style name map.

    ``conv_dtype='float16'`` rounds convolution kernels through f16 (the
    reference loader's policy); ``qtype`` block-quantizes every transformer
    dense kernel and the classifier; ``fused_ir``, ``flash_attn`` and
    ``fused_layer`` pick the kernel routes (module docstring). The root name
    prefix is detected (model or classification export)."""
    if conv_dtype not in (None, "float16"):
        raise NotImplementedError(f"conv_dtype={conv_dtype!r} (bf16 kernel storage) {UNPORTED}")
    if stem_space_to_depth:
        raise NotImplementedError(f"stem_space_to_depth {UNPORTED}")
    if act_storage is not None:
        raise NotImplementedError(f"act_storage {UNPORTED}")
    dev = resolve_device(device)
    if flash_attn is None:
        flash_attn = dev.type == "cuda"
    if fused_layer is None:
        fused_layer = dev.type == "cuda"
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
    cls_key = _find_classifier_key(tensors)
    if cls_key:
        params.classifier_kernel = bld.weight(cls_key)
        params.classifier_bias = bld.t(cls_key.replace("kernel", "bias"))
    if strict and tm.unused():
        raise ValueError(f"unused weights in file: {tm.unused()[:10]} ...")
    return params


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
    load into a template built with the caller's route flags."""
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
        template = from_named_tensors(
            random_named_tensors(config, seed=0, classifier=meta.get("classifier", True)),
            config, qtype=None, device=dev, **kw)
        return checkpoint.load_into(path, template, device=dev)
    named = read_named_tensors(path)
    if config is None:
        config = infer_config(named)
    return from_named_tensors(named, config, device=dev, **kw)
