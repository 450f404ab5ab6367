"""``--scan-layers``: the zoo's homogeneous block runs with their
parameters and BatchNorm buffers stacked on a leading (length,) axis.

Counterpart of ``distributedpytorch_tpu/models/scan.py``.  What stacks,
per model, under flax's names (every other module keeps its name):

  * vit: all ``depth`` ``TransformerBlock``s, ``blocks.block.*``
    (``blocks.block.qkv.weight`` is (depth, 3d, d));
  * vgg: the trailing 512->512 conv+BN pair (plain ``Conv_6``/``Conv_7``,
    ``BatchNorm_6``/``BatchNorm_7``), ``ConvScan_0.{Conv_0, BatchNorm_0}``
    with no ``block`` level;
  * densenet: each dense block's DenseLayer chain (6/12/24/16 layers),
    ``DenseBlockScan_{b}.{BatchNorm_0, Conv_0, BatchNorm_1, Conv_1}``,
    over a zero-padded channel buffer of the block's final width
    (``DenseBlockScan``);
  * inception: the ``InceptionC_1``/``InceptionC_2`` pair (768 channels
    in and out, c7 = 160), ``InceptionCScan_0.block.*``.

JAX runs such a run under ``lax.scan`` so that XLA compiles one block's
program; the port compiles no program, so its run is a Python loop over
the slices and launches what the unrolled model launches.  The stacked
tensors are real: the optimizer steps them, ``parallel.place`` splits
them by their stacked shapes, and a checkpoint holds them as JAX's scan
layout does.  A forward takes every stacked tensor's slices with ONE
``unbind`` (whose backward is one ``stack``, where indexing a step at a
time would materialise the whole stacked gradient once a step) and runs
the block's own module code on step i's slices, bound in place of the
stacked tensors in the modules' ``__dict__`` for the step (``_bound``);
that lookup also takes the place of a placed model's gathered full
tensor, which ``parallel.Placement.gather`` sets there.  BatchNorm moves
its running statistics in place on the step's slice views of the stacked
buffers.  ``forward(x, checkpoint=True)`` (``--remat blocks`` on the vit,
densenet and inception) checkpoints each step as ``remat.run_block``
checkpoints a block, the matmul outputs saved.

``DenseBlockScan`` computes as JAX's ``_DenseStep``: BatchNorm over the
whole buffer, the channels from c_i = c_in + i * growth on masked to zero
after the first ReLU (so the padded rows of the 1x1 conv and of the norm
see zero input and get zero gradient), the 1x1 conv over all c_end
channels, and the step's ``growth`` outputs written at c_i out of place
(a ``cat``: BatchNorm saved the buffer for its backward).  It pays for
the padded channels as JAX does.

Initialisation draws what the unrolled model draws, in its order: step
i's slice of each stacked kernel gets the draw of the unrolled block i's
kernel (a densenet slice its unpadded width, zero-padded), so a scanned
model and an unrolled one from the same generator hold the same weights.

The layout registry (``params_layout``, ``convert_layout``,
``scan_layout_for``, ``KNOWN_LAYOUTS``; JAX :213-505) names and converts
the port's ``state_dict``s and the optimizer moments that mirror them,
by parameter name: vit ``blocks``/``scan`` (and ``stacked``, the
pipelined vit's, through ``models/vit_pipeline.py``), ``vgg_layers``/
``vgg_scan``, ``dense_layers``/``dense_scan`` (cropped and zero-padded
widths) and ``inception_blocks``/``inception_scan``.  Cross-family
targets raise, as JAX's do.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from . import remat, vit_pipeline
from .layers import conv, lecun_draw
from .norm import BatchNorm

_MISSING = object()


@contextlib.contextmanager
def _bound(slots, values):
    """Each (module, name) of ``slots`` reads its value of ``values``
    inside the block: set in the module's ``__dict__``, which attribute
    lookup reads before ``_parameters`` and ``_buffers``; what was there
    before (a placed model's gathered tensor) comes back after."""
    saved = []
    for (owner, attr), value in zip(slots, values):
        saved.append(owner.__dict__.get(attr, _MISSING))
        owner.__dict__[attr] = value
    try:
        yield
    finally:
        for (owner, attr), old in zip(slots, saved):
            if old is _MISSING:
                owner.__dict__.pop(attr, None)
            else:
                owner.__dict__[attr] = old


class Scanned(nn.Module):
    """A run of ``length`` steps of one block whose every parameter and
    buffer is stacked on a leading (length,) axis.  A subclass registers
    one step's modules and defines ``step(x, i)``, then calls
    ``_stack()``."""

    def __init__(self, length: int):
        super().__init__()
        self.length = length

    def _stack(self) -> None:
        """Every parameter and buffer of the step's modules, stacked
        ``length`` times (copies of its initial value)."""
        slots = []
        with torch.no_grad():
            for kind in ("_parameters", "_buffers"):
                for mod in self.modules():
                    for attr, t in list(getattr(mod, kind).items()):
                        if t is None:
                            continue
                        stacked = t.detach().unsqueeze(0).repeat(
                            (self.length,) + (1,) * t.dim())
                        if kind == "_parameters":
                            stacked = nn.Parameter(
                                stacked, requires_grad=t.requires_grad)
                        getattr(mod, kind)[attr] = stacked
                        slots.append((mod, attr))
        self._slots = slots

    def step(self, x: torch.Tensor, i: int) -> torch.Tensor:
        raise NotImplementedError

    def crop(self, name: str, i: int) -> Optional[Tuple[int, int]]:
        """(axis, width) of step i's unpadded slice of stacked tensor
        ``name`` (a name under this module), or None when the slice is
        whole."""
        return None

    def forward(self, x: torch.Tensor, checkpoint: bool = False
                ) -> torch.Tensor:
        slices = [getattr(owner, attr).unbind(0)
                  for owner, attr in self._slots]
        for i, values in enumerate(zip(*slices)):
            x = self._run_step(i, values, x, checkpoint)
        return x

    def _run_step(self, i: int, values, x: torch.Tensor,
                  checkpoint: bool) -> torch.Tensor:
        def run(x):
            with _bound(self._slots, values):
                return self.step(x, i)

        if checkpoint:
            return remat.call(run, x, save_dots=True)
        return run(x)

    def init_stacked_(self, generator: torch.Generator) -> None:
        """flax's initializers, step by step in the unrolled model's
        order: ``lecun_draw`` of each ``Linear``/``Conv2d`` weight of
        step i (at its unpadded width, zero-padded), zero
        biases, BatchNorm's scale 1, bias 0, mean 0 and variance 1."""
        names = {id(m): n for n, m in self.named_modules()}
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, BatchNorm):
                    mod.reset_parameters()
                elif isinstance(mod, (nn.Linear, nn.Conv2d)) \
                        and mod.bias is not None:
                    mod.bias.zero_()
            for i in range(self.length):
                for mod in self.modules():
                    if not isinstance(mod, (nn.Linear, nn.Conv2d)):
                        continue
                    name = f"{names[id(mod)]}.weight"
                    shape = list(mod.weight.shape[1:])
                    cut = self.crop(name, i)
                    if cut is not None:
                        shape[cut[0]] = cut[1]
                    w = lecun_draw(tuple(shape), generator)
                    dst = mod.weight[i]
                    dst.zero_()
                    if cut is not None:
                        dst = dst.narrow(cut[0], 0, cut[1])
                    dst.copy_(w)


class ScanRun(Scanned):
    """``length`` applications of ``block`` (built once, its tensors then
    stacked), under ``block``: JAX ``scan_run``'s ``{name}/block/*``."""

    def __init__(self, block: nn.Module, length: int):
        super().__init__(length)
        self.block = block
        self._stack()

    def step(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return self.block(x)


class VGGScan(Scanned):
    """JAX ``scan_vgg_run``: ``length`` steps of a 3x3 SAME conv with its
    bias (kept for torchvision parity, as the unrolled vgg keeps it),
    BatchNorm and ReLU, under ``Conv_0``/``BatchNorm_0``."""

    def __init__(self, length: int, channels: int, device=None):
        super().__init__(length)
        self.Conv_0 = nn.Conv2d(channels, channels, 3, padding=1,
                                device=device)
        self.BatchNorm_0 = BatchNorm(channels, device=device)
        self._stack()

    def step(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(conv(self.Conv_0, x)))


def _zeros_beside(x: torch.Tensor, channels: int) -> torch.Tensor:
    """Zeros of ``x``'s (B, ``channels``, H, W) in ``x``'s memory format
    (channels_last on the zoo's NHWC input), so that ``cat`` keeps it."""
    b, _, h, w = x.shape
    if not x.is_contiguous() \
            and x.is_contiguous(memory_format=torch.channels_last):
        return x.new_zeros((b, h, w, channels)).permute(0, 3, 1, 2)
    return x.new_zeros((b, channels, h, w))


class DenseBlockScan(Scanned):
    """JAX ``scan_dense_block``: one densenet dense block of ``length``
    DenseLayers over a zero-padded buffer of its final width c_end =
    ``in_features`` + ``length`` * ``growth`` (see the module
    docstring)."""

    def __init__(self, length: int, in_features: int, growth: int,
                 bn_size: int, device=None):
        super().__init__(length)
        self.in_features, self.growth = in_features, growth
        self.c_end = in_features + length * growth
        width = bn_size * growth
        self.BatchNorm_0 = BatchNorm(self.c_end, device=device)
        self.Conv_0 = nn.Conv2d(self.c_end, width, 1, bias=False,
                                device=device)
        self.BatchNorm_1 = BatchNorm(width, device=device)
        self.Conv_1 = nn.Conv2d(width, growth, 3, padding=1, bias=False,
                                device=device)
        self._stack()

    def crop(self, name: str, i: int) -> Optional[Tuple[int, int]]:
        return dense_crop(name, self.in_features + i * self.growth)

    def step(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        c_i = self.in_features + i * self.growth
        valid = (torch.arange(buf.shape[1], device=buf.device) < c_i
                 ).reshape(1, -1, 1, 1)
        y = torch.relu(self.BatchNorm_0(buf))
        y = torch.where(valid, y, 0.0)
        y = conv(self.Conv_0, y)
        y = conv(self.Conv_1, torch.relu(self.BatchNorm_1(y)))
        return torch.cat([buf[:, :c_i], y.to(buf.dtype),
                          buf[:, c_i + self.growth:]], dim=1)

    def forward(self, x: torch.Tensor, checkpoint: bool = False
                ) -> torch.Tensor:
        buf = torch.cat([x, _zeros_beside(x, self.c_end - x.shape[1])],
                        dim=1)
        return super().forward(buf, checkpoint)


def dense_crop(name: str, width: int) -> Optional[Tuple[int, int]]:
    """(axis, width) of a dense layer's tensor ``name`` (relative to the
    layer, one layer's slice) that depends on the layer's input width:
    ``BatchNorm_0``'s four on axis 0, ``Conv_0.weight``'s input channels
    (OIHW axis 1); None for the others (JAX ``_tree_width``)."""
    if name.startswith("BatchNorm_0."):
        return 0, width
    if name == "Conv_0.weight":
        return 1, width
    return None


# -- the layout registry ------------------------------------------------------
#
# Layout names (JAX's):
#   'stacked' / 'blocks'           vit family (models/vit_pipeline.py)
#   'scan'                         vit with --scan-layers
#   'dense_layers' / 'dense_scan'  densenet plain / scanned
#   'vgg_layers' / 'vgg_scan'      vgg plain / scanned
#   'inception_blocks' / 'inception_scan'

_VIT_FAMILY = ("stacked", "blocks", "scan")
_PAIRS = {
    "dense_scan": "dense_layers", "dense_layers": "dense_scan",
    "vgg_scan": "vgg_layers", "vgg_layers": "vgg_scan",
    "inception_scan": "inception_blocks",
    "inception_blocks": "inception_scan",
}
KNOWN_LAYOUTS = frozenset(_VIT_FAMILY) | frozenset(_PAIRS)

# densenet121's geometry (the only densenet of the zoo): growth, the
# blocks' layer counts and the stem's width
_DN_GROWTH, _DN_BLOCKS, _DN_INIT = 32, (6, 12, 24, 16), 64


def densenet_specs(block_config=_DN_BLOCKS, growth: int = _DN_GROWTH,
                   init_features: int = _DN_INIT) -> List[dict]:
    """Per dense block: its scanned name, the flat index of its first
    DenseLayer, its length, entry width and padded width (JAX
    ``_densenet_specs``)."""
    specs, c, offset = [], init_features, 0
    for b, length in enumerate(block_config):
        specs.append({"name": f"DenseBlockScan_{b}", "offset": offset,
                      "length": length, "c_in": c,
                      "c_end": c + length * growth})
        offset += length
        c += length * growth
        if b != len(block_config) - 1:
            c //= 2     # transition compression
    return specs


def _top(sd) -> set:
    return {k.split(".", 1)[0] for k in sd}


def params_layout(sd) -> Optional[str]:
    """The layout of a ``state_dict``-like mapping by parameter name (the
    parameters, or one optimizer moment), or None: no convertible
    layout."""
    vp = vit_pipeline.params_layout(sd)
    if vp is not None:
        return vp
    if not isinstance(sd, dict):
        return None
    if any(k.startswith("blocks.block.") for k in sd):
        return "scan"
    top = _top(sd)
    if "DenseBlockScan_0" in top:
        return "dense_scan"
    if "DenseLayer_0" in top:
        return "dense_layers"
    if "InceptionCScan_0" in top:
        return "inception_scan"
    if "InceptionC_1" in top:
        return "inception_blocks"
    if "ConvScan_0" in top:
        return "vgg_scan"
    if "BatchNorm_7" in top and "BatchNorm_8" not in top \
            and ("Conv_7" in top or "Conv_0" not in top):
        # vgg11_bn is the only zoo model with exactly 8 top-level BN
        # units; the second arm admits a mapping without its convs
        return "vgg_layers"
    return None


def layout_depth(sd: dict, layout: Optional[str]) -> Optional[int]:
    """The vit's depth of a 'stacked' or 'scan' mapping that holds a
    stacked tensor (None otherwise), for the moments that hold none
    (Adam's 0-d step counts)."""
    key = {"stacked": "qkv_kernel",
           "scan": "blocks.block.qkv.weight"}.get(layout)
    t = sd.get(key) if key is not None else None
    return int(t.shape[0]) if isinstance(t, torch.Tensor) and t.dim() \
        else None


def _slice(t, i: int, cut: Optional[Tuple[int, int]] = None):
    """Step i of a stacked tensor (a 0-d tensor, Adam's step, as it is),
    cropped to ``cut``."""
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    t = t[i]
    if cut is not None:
        t = t.narrow(cut[0], 0, cut[1])
    return t.contiguous()


def _pad(t, cut: Optional[Tuple[int, int]], width: int):
    """A step's unpadded tensor zero-padded on ``cut``'s axis to
    ``width``.  Zeros serve every kind (parameters, running statistics,
    moments): the padded entries are masked out of the forward, get zero
    gradient, and zero moments leave them alone."""
    if cut is None or not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    axis = cut[0]
    pad = [0, 0] * (t.dim() - 1 - axis) + [0, width - t.shape[axis]]
    return torch.nn.functional.pad(t, pad)


def _stack(parts: list):
    if not isinstance(parts[0], torch.Tensor) or parts[0].dim() == 0:
        return parts[0]
    return torch.stack(parts)


# A run: (scanned prefix, the plain prefixes of its steps, the step's
# crop (relative name, step) -> (axis, width) or None, the padded width)
_Run = Tuple[str, List[str], Callable, int]


def _no_crop(name: str, i: int):
    return None


def _runs(layout: str, sd: dict, depth: Optional[int]) -> List[_Run]:
    """The scanned runs of a family's layout pair, read off ``sd`` (the
    vit's depth from its stacked tensors or block names, else
    ``depth``)."""
    if layout in ("scan", "blocks"):
        if depth is None:
            depth = layout_depth(sd, "scan")
        if depth is None:
            idx = [int(m.group(1)) for k in sd
                   for m in [re.match(r"blocks\.(\d+)\.", k)] if m]
            depth = 1 + max(idx) if idx else 0
        return [("blocks.block.", [f"blocks.{i}." for i in range(depth)],
                 _no_crop, 0)]
    if layout in ("vgg_scan", "vgg_layers"):
        return [(f"ConvScan_0.{kind}_0.", [f"{kind}_{i}." for i in (6, 7)],
                 _no_crop, 0) for kind in ("Conv", "BatchNorm")]
    if layout in ("inception_scan", "inception_blocks"):
        return [("InceptionCScan_0.block.",
                 ["InceptionC_1.", "InceptionC_2."], _no_crop, 0)]
    runs = []
    for s in densenet_specs():
        def crop(name, i, c_in=s["c_in"]):
            return dense_crop(name, c_in + i * _DN_GROWTH)

        runs.append((f"{s['name']}.",
                     [f"DenseLayer_{s['offset'] + i}."
                      for i in range(s["length"])], crop, s["c_end"]))
    return runs


def _unstack(sd: dict, runs: List[_Run]) -> dict:
    out = {}
    for k, v in sd.items():
        run = next((r for r in runs if k.startswith(r[0])), None)
        if run is None:
            out[k] = v
            continue
        prefix, plains, crop, _ = run
        rest = k[len(prefix):]
        for i, plain in enumerate(plains):
            out[plain + rest] = _slice(v, i, crop(rest, i))
    return out


def _restack(sd: dict, runs: List[_Run]) -> dict:
    out = {}
    for k, v in sd.items():
        run = next((r for r in runs if k.startswith(r[1][0])), None)
        if run is None:
            if not any(k.startswith(p) for r in runs for p in r[1]):
                out[k] = v
            continue
        prefix, plains, crop, width = run
        rest = k[len(plains[0]):]
        out[prefix + rest] = _stack([
            _pad(sd[plain + rest], crop(rest, i), width)
            for i, plain in enumerate(plains)])
    return out


_SCANNED = frozenset({"scan", "vgg_scan", "dense_scan", "inception_scan"})


def convert_layout(sd: dict, target: str,
                   depth: Optional[int] = None) -> dict:
    """A ``state_dict``-like mapping (parameters with their buffers, or
    one optimizer moment by parameter name) in the ``target`` layout; one
    already in it, or of no convertible layout, as it is.  ``depth``: the
    vit's blocks when the mapping holds no stacked tensor to read it from
    (Adam's 0-d step counts alone).  A target of another model family
    raises, as JAX's ``convert_layout`` does."""
    if target not in KNOWN_LAYOUTS:
        raise ValueError(f"unknown layout {target!r}")
    layout = params_layout(sd)
    if layout is None or layout == target:
        return sd
    if layout in _VIT_FAMILY and target in _VIT_FAMILY:
        # transitive through 'blocks' (scan <-> stacked)
        mid = sd
        if layout == "stacked":
            mid = vit_pipeline.convert_layout(sd, "blocks", depth)
        elif layout == "scan":
            mid = _unstack(sd, _runs("scan", sd, depth))
        if target == "blocks":
            return mid
        if target == "scan":
            return _restack(mid, _runs("blocks", mid, depth))
        return vit_pipeline.convert_layout(mid, "stacked")
    if _PAIRS.get(layout) != target:
        raise ValueError(
            f"cannot convert a {layout!r}-layout tree to {target!r} "
            "(different model families)")
    runs = _runs(layout, sd, depth)
    return (_unstack(sd, runs) if layout in _SCANNED
            else _restack(sd, runs))


def scan_layout_for(layout: Optional[str]) -> Optional[str]:
    """The scanned twin of a plain layout (and vice versa); None when the
    layout has no twin."""
    if layout in ("blocks", "stacked"):
        return "scan"
    if layout == "scan":
        return "blocks"
    return _PAIRS.get(layout)
