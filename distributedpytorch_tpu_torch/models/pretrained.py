"""``--use-pretrained``: a torchvision ``state_dict`` -> the port model's
backbone.

Counterpart of ``distributedpytorch_tpu/models/pretrained.py`` (:36-341).
The reference's fine-tuning story is ``use_pretrained=True``: every
factory in ref utils.py:38-105 loads torchvision ImageNet weights, then
replaces the classifier head, optionally freezing the backbone
(``--feature-extract``).  Here the weights come from a ``.pth`` file the
user provides (this package never downloads), read with
``torch.load(weights_only=True)``.

The converters are the JAX package's own, numpy only (torchvision keys ->
flax ``params`` / ``batch_stats`` trees; the first linear after a flatten
has its input axis permuted from torch's CHW flatten order to the HWC
order the models flatten in).  ``load_pretrained`` composes them with
``models.convert``: the model's ``state_dict`` goes to flax trees
(``cnn_params_to_jax``), the converted backbone is merged into them with
the JAX ``convert_state_dict`` (its key and shape checks, its errors word
for word), and the result goes back (``cnn_params_from_jax``) into the
model.  So the ``head`` (and inception's ``aux_head``) keep their fresh
initialisation, as the reference replaces them after the load.

Supported: resnet18, alexnet, vgg11_bn, squeezenet1_0, densenet121 and
inception_v3; any other architecture raises.  A vgg, densenet or
inception built with ``--scan-layers`` holds its block run stacked
(``models/scan.py``) under names the converted keys do not match, so the
merge refuses it with JAX's own error (``converted key /Conv_6 not in
model``, ``/DenseLayer_0``, ``/InceptionC_1``), as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .convert import cnn_params_from_jax, cnn_params_to_jax

SUPPORTED = ("resnet", "alexnet", "vgg", "squeezenet", "densenet",
             "inception")


def _t_conv(w) -> np.ndarray:
    return np.asarray(w, np.float32).transpose(2, 3, 1, 0)


def _t_linear(w, spatial: Optional[Tuple[int, int, int]] = None
              ) -> np.ndarray:
    """(O,I) -> (I,O); with ``spatial=(C,H,W)`` also permute the input axis
    from CHW-flatten order to HWC-flatten order."""
    w = np.asarray(w, np.float32)
    if spatial is not None:
        c, h, wd = spatial
        w = w.reshape(-1, c, h, wd).transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
    return w.T


def _vec(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _bn(sd: Dict[str, Any], prefix: str):
    """(params {scale,bias}, stats {mean,var}) for one torch BN layer."""
    return (
        {"scale": _vec(sd[f"{prefix}.weight"]),
         "bias": _vec(sd[f"{prefix}.bias"])},
        {"mean": _vec(sd[f"{prefix}.running_mean"]),
         "var": _vec(sd[f"{prefix}.running_var"])},
    )


def _convert_resnet18(sd: Dict[str, Any]):
    """torchvision resnet18 state_dict -> (params, batch_stats), no head."""
    params: Dict[str, Any] = {"Conv_0": {"kernel": _t_conv(sd["conv1.weight"])}}
    stats: Dict[str, Any] = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn(sd, "bn1")
    # torchvision layer{1..4}.{0,1} -> BasicBlock_{0..7}; downsample
    # projections exist at layer{2,3,4}.0 and are our Conv_2/BatchNorm_2.
    for layer in range(1, 5):
        for block in range(2):
            i = (layer - 1) * 2 + block
            t = f"layer{layer}.{block}"
            b_params: Dict[str, Any] = {
                "Conv_0": {"kernel": _t_conv(sd[f"{t}.conv1.weight"])},
                "Conv_1": {"kernel": _t_conv(sd[f"{t}.conv2.weight"])},
            }
            b_stats: Dict[str, Any] = {}
            b_params["BatchNorm_0"], b_stats["BatchNorm_0"] = _bn(sd, f"{t}.bn1")
            b_params["BatchNorm_1"], b_stats["BatchNorm_1"] = _bn(sd, f"{t}.bn2")
            if f"{t}.downsample.0.weight" in sd:
                b_params["Conv_2"] = {
                    "kernel": _t_conv(sd[f"{t}.downsample.0.weight"])}
                b_params["BatchNorm_2"], b_stats["BatchNorm_2"] = _bn(
                    sd, f"{t}.downsample.1")
            params[f"BasicBlock_{i}"] = b_params
            stats[f"BasicBlock_{i}"] = b_stats
    return params, stats


def _convert_alexnet(sd: Dict[str, Any]):
    """torchvision alexnet: features.{0,3,6,8,10} convs,
    classifier.{1,4} linears (classifier.6 is the replaced head)."""
    params: Dict[str, Any] = {}
    for i, t in enumerate((0, 3, 6, 8, 10)):
        params[f"Conv_{i}"] = {
            "kernel": _t_conv(sd[f"features.{t}.weight"]),
            "bias": _vec(sd[f"features.{t}.bias"])}
    params["Dense_0"] = {
        "kernel": _t_linear(sd["classifier.1.weight"], spatial=(256, 6, 6)),
        "bias": _vec(sd["classifier.1.bias"])}
    params["Dense_1"] = {"kernel": _t_linear(sd["classifier.4.weight"]),
                         "bias": _vec(sd["classifier.4.bias"])}
    return params, {}


def _convert_vgg11_bn(sd: Dict[str, Any]):
    """torchvision vgg11_bn: features conv/BN pairs at
    (0,1),(4,5),(8,9),(11,12),(15,16),(18,19),(22,23),(25,26);
    classifier.{0,3} linears (classifier.6 is the replaced head)."""
    pairs = ((0, 1), (4, 5), (8, 9), (11, 12), (15, 16), (18, 19),
             (22, 23), (25, 26))
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i, (c, b) in enumerate(pairs):
        params[f"Conv_{i}"] = {
            "kernel": _t_conv(sd[f"features.{c}.weight"]),
            "bias": _vec(sd[f"features.{c}.bias"])}
        params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = _bn(
            sd, f"features.{b}")
    params["Dense_0"] = {
        "kernel": _t_linear(sd["classifier.0.weight"], spatial=(512, 7, 7)),
        "bias": _vec(sd["classifier.0.bias"])}
    params["Dense_1"] = {"kernel": _t_linear(sd["classifier.3.weight"]),
                         "bias": _vec(sd["classifier.3.bias"])}
    return params, stats


def _convert_squeezenet(sd: Dict[str, Any]):
    """torchvision squeezenet1_0: features.0 stem conv; Fire modules at
    features.{3,4,5,7,8,9,10,12} with squeeze/expand1x1/expand3x3 convs
    (classifier.1 is the replaced head, ref utils.py:74)."""
    def conv(prefix):
        return {"kernel": _t_conv(sd[f"{prefix}.weight"]),
                "bias": _vec(sd[f"{prefix}.bias"])}

    params: Dict[str, Any] = {"Conv_0": conv("features.0")}
    for i, t in enumerate((3, 4, 5, 7, 8, 9, 10, 12)):
        params[f"Fire_{i}"] = {
            "Conv_0": conv(f"features.{t}.squeeze"),
            "Conv_1": conv(f"features.{t}.expand1x1"),
            "Conv_2": conv(f"features.{t}.expand3x3"),
        }
    return params, {}


def _convert_densenet121(sd: Dict[str, Any]):
    """torchvision densenet121: conv0/norm0 stem; denseblock{1..4} of
    denselayer{n} (norm1/conv1/norm2/conv2); transition{1..3} (norm/conv);
    norm5 (classifier is the replaced head, ref utils.py:83-84).

    Flax numbering: DenseLayer_{0..57} run cumulatively across blocks;
    transitions are the top-level BatchNorm_{1..3}/Conv_{1..3}; the final
    norm is BatchNorm_4."""
    params: Dict[str, Any] = {
        "Conv_0": {"kernel": _t_conv(sd["features.conv0.weight"])}}
    stats: Dict[str, Any] = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn(sd, "features.norm0")
    li = 0
    block_config = (6, 12, 24, 16)
    for b, n_layers in enumerate(block_config, start=1):
        for n in range(1, n_layers + 1):
            t = f"features.denseblock{b}.denselayer{n}"
            lp: Dict[str, Any] = {}
            ls: Dict[str, Any] = {}
            lp["BatchNorm_0"], ls["BatchNorm_0"] = _bn(sd, f"{t}.norm1")
            lp["Conv_0"] = {"kernel": _t_conv(sd[f"{t}.conv1.weight"])}
            lp["BatchNorm_1"], ls["BatchNorm_1"] = _bn(sd, f"{t}.norm2")
            lp["Conv_1"] = {"kernel": _t_conv(sd[f"{t}.conv2.weight"])}
            params[f"DenseLayer_{li}"] = lp
            stats[f"DenseLayer_{li}"] = ls
            li += 1
        if b < len(block_config):
            t = f"features.transition{b}"
            params[f"BatchNorm_{b}"], stats[f"BatchNorm_{b}"] = _bn(
                sd, f"{t}.norm")
            params[f"Conv_{b}"] = {"kernel": _t_conv(sd[f"{t}.conv.weight"])}
    params["BatchNorm_4"], stats["BatchNorm_4"] = _bn(sd, "features.norm5")
    return params, stats


def _basic_conv(sd: Dict[str, Any], prefix: str):
    """torchvision BasicConv2d (conv bias-free + bn) -> our BasicConv
    submodule trees."""
    p = {"Conv_0": {"kernel": _t_conv(sd[f"{prefix}.conv.weight"])}}
    p["BatchNorm_0"], bn_stats = _bn(sd, f"{prefix}.bn")
    return p, {"BatchNorm_0": bn_stats}


# Branch creation order inside each Flax Inception{A..E} module == the
# torchvision submodule order (models/inception.py mirrors it).
_INCEPTION_BRANCHES = {
    "A": ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"),
    "B": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
    "C": ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
          "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
          "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"),
    "D": ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
          "branch7x7x3_3", "branch7x7x3_4"),
    "E": ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
          "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
          "branch3x3dbl_3b", "branch_pool"),
}

_INCEPTION_MIXED = (
    ("InceptionA_0", "Mixed_5b", "A"), ("InceptionA_1", "Mixed_5c", "A"),
    ("InceptionA_2", "Mixed_5d", "A"), ("InceptionB_0", "Mixed_6a", "B"),
    ("InceptionC_0", "Mixed_6b", "C"), ("InceptionC_1", "Mixed_6c", "C"),
    ("InceptionC_2", "Mixed_6d", "C"), ("InceptionC_3", "Mixed_6e", "C"),
    ("InceptionD_0", "Mixed_7a", "D"), ("InceptionE_0", "Mixed_7b", "E"),
    ("InceptionE_1", "Mixed_7c", "E"),
)


def _convert_inception_v3(sd: Dict[str, Any]):
    """torchvision inception_v3 (aux_logits=True): stem Conv2d_* BasicConvs,
    Mixed_5b..7c blocks, AuxLogits conv0/conv1.  BOTH fc heads (fc and
    AuxLogits.fc) stay fresh — the reference replaces both
    (ref utils.py:93-98)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    stem = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
            "Conv2d_3b_1x1", "Conv2d_4a_3x3")
    for i, t in enumerate(stem):
        params[f"BasicConv_{i}"], stats[f"BasicConv_{i}"] = _basic_conv(sd, t)
    for flax_name, torch_name, kind in _INCEPTION_MIXED:
        mp: Dict[str, Any] = {}
        ms: Dict[str, Any] = {}
        for i, branch in enumerate(_INCEPTION_BRANCHES[kind]):
            mp[f"BasicConv_{i}"], ms[f"BasicConv_{i}"] = _basic_conv(
                sd, f"{torch_name}.{branch}")
        params[flax_name] = mp
        stats[flax_name] = ms
    aux_p: Dict[str, Any] = {}
    aux_s: Dict[str, Any] = {}
    aux_p["BasicConv_0"], aux_s["BasicConv_0"] = _basic_conv(
        sd, "AuxLogits.conv0")
    aux_p["BasicConv_1"], aux_s["BasicConv_1"] = _basic_conv(
        sd, "AuxLogits.conv1")
    params["AuxHead_0"] = aux_p
    stats["AuxHead_0"] = aux_s
    return params, stats


_CONVERTERS = {
    "resnet": _convert_resnet18,
    "alexnet": _convert_alexnet,
    "vgg": _convert_vgg11_bn,
    "squeezenet": _convert_squeezenet,
    "densenet": _convert_densenet121,
    "inception": _convert_inception_v3,
}


def convert_state_dict(model_name: str, sd: Dict[str, Any],
                       params: Any, batch_stats: Any):
    """Merge a torch state_dict into fresh Flax trees.

    Backbone leaves are replaced by the converted torch weights; the
    ``head`` (and any other key the converter does not produce) keeps its
    fresh initialization — the reference's replace-head-after-load
    semantics (ref utils.py:46-48).  Shapes are validated leaf-by-leaf.
    """
    if model_name not in _CONVERTERS:
        raise ValueError(
            f"use_pretrained is not supported for {model_name!r} "
            f"(supported: {', '.join(SUPPORTED)})")
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    try:
        conv_params, conv_stats = _CONVERTERS[model_name](sd)
    except KeyError as e:
        raise ValueError(
            f"state_dict is missing key {e.args[0]!r} — is this really a "
            f"torchvision {model_name} state_dict?") from e

    def merge(fresh, converted, path=""):
        out = dict(fresh)
        for k, v in converted.items():
            if k not in fresh:
                raise ValueError(f"converted key {path}/{k} not in model")
            if isinstance(v, dict):
                out[k] = merge(fresh[k], v, f"{path}/{k}")
            else:
                if tuple(np.shape(fresh[k])) != tuple(v.shape):
                    raise ValueError(
                        f"shape mismatch at {path}/{k}: model "
                        f"{tuple(np.shape(fresh[k]))} vs weights {v.shape}")
                out[k] = v
        return out

    return merge(params, conv_params), merge(batch_stats, conv_stats)


def validate_request(model_name: str, path: Optional[str]) -> None:
    """Cheap use_pretrained precondition check — callable before any data
    or model work so user mistakes fail in milliseconds."""
    if model_name not in _CONVERTERS:
        raise ValueError(
            f"use_pretrained is not supported for {model_name!r} "
            f"(supported: {', '.join(SUPPORTED)})")
    if not path:
        raise ValueError(
            "use_pretrained requires --pretrained-path FILE (a torchvision "
            f"{model_name} state_dict saved with torch.save); this "
            "framework never downloads weights")


def _numpy(v: Any) -> Any:
    """A tensor as numpy (a half-precision one widened to f32)."""
    if not isinstance(v, torch.Tensor):
        return v
    return (v.float() if v.is_floating_point() else v).numpy()


def load_pretrained(model_name: str, path: Optional[str],
                    model: nn.Module) -> None:
    """Load a user-provided ``.pth``/``.pt`` torch checkpoint (a bare
    state_dict or a dict with a ``state_dict`` field; a ``module.``
    prefix is stripped) into ``model``'s backbone, in place.  Every
    failure is a ValueError."""
    validate_request(model_name, path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # any torch.load failure -> CLI ValueError
        raise ValueError(f"cannot load pretrained weights {path!r}: {e}") \
            from e
    if not isinstance(obj, dict):
        raise ValueError(
            f"pretrained weights {path!r} did not contain a state_dict "
            f"(got {type(obj).__name__})")
    sd = {k: _numpy(v) for k, v in obj.get("state_dict", obj).items()}
    params, batch_stats = cnn_params_to_jax(model.state_dict())
    params, batch_stats = convert_state_dict(model_name, sd, params,
                                             batch_stats)
    model.load_state_dict(cnn_params_from_jax(params, batch_stats))
