"""Forward slice sweep of the 4-channel reference medium: the wrapper in
place of volumetricrenderer_tpu/kernels/sweep_pallas.py's
sweep_base_pallas_ref, its hand-written CUDA kernel (csrc/sweep_ref_fwd.cu,
in place of `_fwd_kernel_ref`) and the kernel's plain PyTorch version
(sweep_ref_fwd_reference).

The reference medium samples four noise channels, each at its own scaled
and scrolled coordinate with mirror addressing, and combines them as
sigma = (s1*s2)*(s3+s4)*sample_scale. As in the JAX package, the
sweep-axis third of each channel's trilinear sample is taken outside the
kernel, in plain PyTorch (_layer_channels): the kernel sweeps the
pre-lerped channel slabs L (S, 4, A, B), its gradient is dL, and the node
_LayerChannels carries dL through the lerp to the grid.

`sweep_base_ref` runs the sweep as one autograd node on either device: on
a CUDA tensor its forward launches this kernel and its backward the
backward kernel of kernels/sweep_ref_bwd.py (the port of `_bwd_kernel_ref`),
or they raise; on a CPU tensor they run the two plain versions. There is no
fallback from one device's path to the other's.

With a light-transmittance volume (ops/lighting.py, built from
ops/media.materialize_sigma for this medium) the emission sweep shades
every sample as the single-channel sweep does. The light is no scrolled
noise channel: its stack is pre-lerped onto the slice planes like a
channel with scale 1 and no offset, and sampled at the unscaled
coordinates. The node then has two differentiable inputs, L and the light
slabs.

The kernels run sweep_fwd's tiled schedule with one tap window per
channel (csrc/sweep_ref_tile.cuh). The stage they take is sized once per
plan and medium (build.ref_stage_for, from the plan and the channels'
coordinate scales, not the scroll's offsets), so an animated scroll pays no
read to the host per frame; `tiles` tallies the tile-slices the kernel
computed and those it read through global memory. The inputs a frame builds
on the host side cost no copy to the device either: the medium's scales and
weights are device vectors made once per device, the params' per-plan head
once per plan, and the four channels' layers are one vectorised lerp.

RenderConfig(dtype="bfloat16") sweeps in the bfloat16 stream mode that
kernels/sweep_fwd.py defines: L is built in float32 (_layer_channels), the
node casts L and the light slabs to bfloat16, sweeps and saves the casts,
and every channel's tap weights are rounded to bfloat16 on their own. dL
comes back in float32 (the JAX package rounds it to bfloat16; the port
does not).

The layers of all channels are fetched by one gather and lerped at once.
Under autograd they are one node of their own (_LayerChannels), whose
backward is written out: the lerp's two weights on dL and one index_add_
of every channel's two layers into the gradient of the permuted grid. A
sweep without a scroll (a fit's) works its layer taps out once per plan.

`launches` counts the kernel launches made by this module, and
`layer_backwards` the channel layers' backward passes. Spans
(utils/clock.py): "sweep.ref_layers", with its device interval, around the
channel-layer build in sweep_base_ref (_layer_channels, and the light slabs
where there are any); "sweep.ref_layers_bwd", with its device interval,
around the channel layers' backward (on autograd's device thread on a
card); "sweep.ref_fwd" and "sweep.ref_bwd", host time only, around the
node's forward and backward sweeps: on a CUDA tensor K4's and K5's launch
wrappers, on a CPU tensor their plain versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ..config import LightConfig, MediumConfig, RenderConfig
from ..ops.sampling import apply_address_mode, clip_unit
from ..utils import clock
from . import sweep_ref_bwd
from .build import (N_PARAMS, NCH, IdentityCache, TileTally,
                    build_library, channel_resample, check_sweep_inputs,
                    light_sample, ref_stage_cap, ref_stage_for, stream_cast)
from .sweep_fwd import _layer_lerp_stack, _params_for

__all__ = ["sweep_ref_inputs", "sweep_ref_light_slabs", "sweep_base_ref",
           "sweep_ref_apply", "sweep_ref_fwd_reference", "build_kernel",
           "launch_kernel", "launches", "layer_backwards", "tiles"]

launches = 0  # kernel launches since import (or since a caller reset it)
layer_backwards = 0  # _LayerChannels backward passes, counted likewise
tiles = TileTally()  # tile-slices (computed, read through global memory)

_lib = None
build_info = None  # set by the first build: path, seconds, nvcc output


@functools.lru_cache(maxsize=64)
def _device_vector(values, device):
    """The float32 tensor of a tuple of the medium's per-channel constants
    on `device`, made once: a frame copies nothing to the device."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _channel_offsets(medium: MediumConfig, scroll, coord_order, device=None):
    """Per-channel scroll offsets scroll[c] * channel_scroll_weight[c] in
    the plan's (k, a, b) coord order: a list of NCH (offk, offa, offb)
    triples of 0-dim float32 tensors (zeros with no scroll), views of one
    (NCH, 3) product."""
    c_k, c_a, c_b = coord_order
    if scroll is None:
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return [(zero, zero, zero)] * NCH
    scroll = torch.as_tensor(scroll, dtype=torch.float32, device=device)
    weights = _device_vector(tuple(medium.channel_scroll_weight),
                             scroll.device)
    o = scroll * weights[:, None]
    return [(o[c, c_k], o[c, c_a], o[c, c_b]) for c in range(NCH)]


def _layer_taps(depth, slice_z, medium: MediumConfig, offs, address_mode):
    """Per slice s and channel c, the two layers bracketing the sweep
    coord slice_z[s] * scale_c + offk_c and their lerp weights: (layers,
    w), layers (2, S, NCH) int64 (the lower layer, then the upper) and w
    (2, S, NCH, 1, 1) float32 (1 - f, then f). Each channel's positions
    are worked out in its own float32 arithmetic."""
    dev = slice_z.device
    scales = _device_vector(tuple(medium.channel_coord_scale), dev)
    offk = torch.stack([offs[c][0] for c in range(NCH)]).to(dev)
    p = (scales[:, None] * slice_z + offk[:, None]) * depth - 0.5
    i0f = torch.floor(p)
    f = (p - i0f).to(torch.float32).T[:, :, None, None]
    i0 = i0f.to(torch.int64).T
    layers = torch.stack((apply_address_mode(i0, depth, address_mode),
                          apply_address_mode(i0 + 1, depth, address_mode)))
    return layers, torch.stack((1.0 - f, f))


@functools.lru_cache(maxsize=16)
def _channels(device):
    """(NCH,) int64 0, 1, .., NCH - 1 on `device`, made once."""
    return torch.arange(NCH, dtype=torch.int64, device=device)


def _lerp_layers(g, layers, w):
    """The (S, NCH, A, B) lerp lo * (1 - f) + hi * f of each channel's two
    layers of g (D, A, B, C) float32, both fetched by one gather."""
    both = g[layers, :, :, _channels(g.device)]
    return both[0] * w[0] + both[1] * w[1]


def _layer_adjoint(dL, layers, w, shape):
    """The gradient of _lerp_layers' (S, NCH, A, B) output dL with respect
    to g of `shape` (D, A, B, C): channel c's layer layers[0, s, c] gets
    dL[s, c] * (1 - f) and layer layers[1, s, c] gets dL[s, c] * f, summed
    over the slices that read it, by one index_add_ into a channel-major
    (C * D, A, B) gradient (atomics on a card), returned as its
    (D, A, B, C) float32 view."""
    depth, A, B, C = shape
    rows = layers + _channels(dL.device) * depth
    grad = torch.zeros((C * depth, A, B), dtype=torch.float32,
                       device=dL.device)
    grad.index_add_(0, rows.view(-1), (dL.unsqueeze(0) * w).view(-1, A, B))
    return grad.view(C, depth, A, B).permute(1, 2, 3, 0)


class _LayerChannels(torch.autograd.Function):
    """The channel layers as one autograd node, differentiable in the
    permuted grid gperm4 (D, A, B, C) alone. The forward is _lerp_layers,
    the backward _layer_adjoint. Span "sweep.ref_layers_bwd" with its
    device interval; counted in layer_backwards."""

    @staticmethod
    def forward(ctx, gperm4, layers, w):
        ctx.save_for_backward(layers, w)
        ctx.shape, ctx.dtype = gperm4.shape, gperm4.dtype
        return _lerp_layers(gperm4.to(torch.float32), layers, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, dL):
        global layer_backwards
        layers, w = ctx.saved_tensors
        with clock.span("sweep.ref_layers_bwd", device=dL):
            grad = _layer_adjoint(dL, layers, w, ctx.shape)
            layer_backwards += 1
        return grad.to(ctx.dtype), None, None


def _lerp_channels(gperm4, layers, w):
    """_lerp_layers of gperm4 at the taps of _layer_taps: where autograd
    records it, the node _LayerChannels, whose backward is one
    index_add_."""
    if torch.is_grad_enabled() and gperm4.requires_grad:
        return _LayerChannels.apply(gperm4, layers, w)
    return _lerp_layers(gperm4.to(torch.float32), layers, w)


def _layer_channels(gperm4, slice_z, medium: MediumConfig, offs,
                    address_mode):
    """For every slice s and channel c, the layer-lerped 2-D slab of
    channel c at sweep coord slice_z[s] * scale_c + offk_c: the sweep-axis
    third of the trilinear sample. gperm4 (D, A, B, C) -> (S, NCH, A, B),
    in slice_z (front-to-back) order. The layer pairs of all channels are
    worked out at once, in each channel's own float32 arithmetic, and the
    lerp is one. Differentiable in gperm4 (_lerp_channels)."""
    return _lerp_channels(gperm4, *_layer_taps(
        gperm4.shape[0], slice_z, medium, offs, address_mode))


_PARAMS_HEAD = IdentityCache()
_STILL = IdentityCache()  # sweep_ref_inputs' taps and params, no scroll


def _params_ref(plan, cfg: RenderConfig, medium: MediumConfig,
                light: LightConfig, offs) -> torch.Tensor:
    """(N_PARAMS,) float32: _params_for's eight, the four channel coord
    scales, the four b offsets and the four a offsets. (The TPU kernel
    takes the first sixteen and gets the a offsets inside its row
    matrices, which this port does not build.) The first twelve are one
    tensor per plan and medium."""
    head8 = _params_for(plan, cfg, medium, light)
    head = _PARAMS_HEAD.get(
        (head8,), tuple(medium.channel_coord_scale),
        lambda: torch.cat([head8, _device_vector(
            tuple(medium.channel_coord_scale), head8.device)]))
    return torch.cat([head, torch.stack(
        [offs[c][2] for c in range(NCH)] + [offs[c][1] for c in range(NCH)])])


def sweep_ref_fwd_reference(L, slice_z, v_grid, u_grid, seglen, params, *,
                            emission: bool, light=None, _low=None):
    """Plain PyTorch version of the 4-channel sweep kernel, with the same
    inputs.

    L: (S, 4, A, B) float32 or bfloat16 pre-lerped channel slabs in slice
    order; slice_z (S,), v_grid (Hb,), u_grid (Wb,), seglen (Hb, Wb),
    params (N_PARAMS,) as _params_ref. Each channel of each slice is
    resampled as Wa @ L[s, c] @ Wb^T with banded matrices at its scaled and
    scrolled coords; out-of-box and behind-the-eye samples are masked on
    the unscaled coords. light: optional (S, A, B) light slabs in slice
    order and L's dtype (emission only), resampled at the unscaled coords
    with clipped taps. Bfloat16 slabs are the bfloat16 stream mode: texels
    widened to float32, every tap weight rounded to bfloat16; the private
    _low=True forces that arithmetic on float32 slabs, as in
    sweep_fwd.sweep_fwd_reference.
    Returns (acc, trans, wsum, hit), each (Hb, Wb) float32."""
    if light is not None and not emission:
        raise ValueError("sweep: a light volume needs emission")
    S, _, A, B = L.shape
    low = L.dtype == torch.bfloat16 if _low is None else _low
    Hb, Wb = v_grid.shape[0], u_grid.shape[0]
    e_k, e_a, e_b, sign, density, sscale, thresh, ambient = (
        params[n] for n in range(8))
    kw = dict(dtype=torch.float32, device=L.device)
    acc = torch.zeros((Hb, Wb), **kw)
    trans = torch.ones((Hb, Wb), **kw)
    wsum = torch.zeros((Hb, Wb), **kw)
    hit = torch.zeros((Hb, Wb), **kw)
    for s in range(S):
        delta = slice_z[s] - e_k
        a01 = e_a + delta * v_grid
        b01 = e_b + delta * u_grid
        front = (delta * sign) > 0.0
        mask = ((a01 >= 0.0) & (a01 <= 1.0))[:, None] \
            & ((b01 >= 0.0) & (b01 <= 1.0))[None, :] & front
        maskf = mask.to(torch.float32)
        r = []
        for c in range(NCH):
            Wa, Wbm = channel_resample(a01, b01, params, c, A, B, low)
            r.append(Wa @ L[s, c].to(torch.float32) @ Wbm.T)
        sigma = (r[0] * r[1]) * (r[2] + r[3]) * sscale * maskf
        if emission:
            live = (trans > thresh).to(torch.float32)
            alpha = live * (1.0 - torch.exp(-density * sigma * seglen))
            shade = 1.0  # a product with 1.0 is exact: the no-light sum
            if light is not None:
                lT = light_sample(light[s], a01, b01, "clamp", low)
                shade = ambient + (1.0 - ambient) * clip_unit(lT)
            wsum = wsum + trans * alpha * shade
            trans = trans * (1.0 - alpha)
        else:
            acc = acc + sigma * seglen
            hit = torch.maximum(hit, maskf)
    return acc, trans, wsum, hit


def build_kernel():
    """Build (at first use) and load the kernel's library; returns the
    build info: library path, build seconds, nvcc's ptxas report."""
    global _lib, build_info
    if _lib is None:
        lib, info = build_library("sweep_ref_fwd")
        fn = lib.sweep_ref_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _lib, build_info = lib, info
    return build_info


def launch_kernel(L, slice_z, v_grid, u_grid, seglen, params, emission,
                  light=None, stage=None):
    """Check the inputs, allocate the (4, Hb, Wb) output, launch the
    kernel on the current stream and count the launch. `L` is float32 or
    bfloat16 (the stream mode: it selects the kernel's instantiation).
    `light` is the optional (S, A, B) stack of light slabs in slice order
    and L's dtype (emission only): it selects the kernel's light branch.
    v_grid and u_grid must be monotone, as plan_sweep makes them. `stage`:
    slots per window buffer; None sizes it (build.ref_stage_for, cached on
    these very tensors, `params` included), 0 reads every tile-slice
    through global memory. Returns the (4, Hb, Wb) float32 tensor of acc,
    trans, wsum, hit."""
    global launches
    dev = L.device
    if light is not None and not emission:
        raise ValueError("sweep_ref_fwd kernel: a light volume needs "
                         "emission")
    S, A, B, Hb, Wb, elem = check_sweep_inputs(
        "sweep_ref_fwd", L, slice_z, v_grid, u_grid, seglen, params,
        channels=NCH, n_params=N_PARAMS, light=light)
    build_kernel()
    if stage is None:
        stage = ref_stage_for(slice_z, v_grid, u_grid, params, A, B,
                              light=light is not None)
    cap = ref_stage_cap(stage, False, light is not None)
    out = torch.empty((4, Hb, Wb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib.sweep_ref_fwd_launch(
            L.data_ptr(), light.data_ptr() if light is not None else None,
            slice_z.data_ptr(), v_grid.data_ptr(), u_grid.data_ptr(),
            seglen.data_ptr(), params.data_ptr(), out.data_ptr(), S, A, B,
            Hb, Wb, int(emission), elem, cap, tiles.tensor(dev).data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"sweep_ref_fwd kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


class _SweepRef(torch.autograd.Function):
    """The 4-channel sweep as an autograd node, in place of
    _fused_vjp_ref's f_fwd and f_bwd, without and with light slabs: the
    kernels on CUDA slabs, the plain versions on CPU slabs. There are no
    checkpoint outputs: the backward replays each ray from T = 1. L and
    the light slabs (or None) get gradients; `hit` is not differentiable.
    `low` is the bfloat16 stream mode, handled as in sweep_fwd._SweepFwd:
    the cast to the stream type, the sweep and the saved tensors are the
    node's, and each float32 gradient returns in its input's dtype. `stage`
    is both kernels' stage (launch_kernel's; None sizes it per call)."""

    @staticmethod
    def forward(ctx, L, light, slice_z, v_grid, u_grid, seglen, params,
                emission, low, stage):
        ctx.in_dtypes = (L.dtype, None if light is None else light.dtype)
        L, light = stream_cast(L, low), stream_cast(light, low)
        with clock.span("sweep.ref_fwd"):
            if L.device.type == "cuda":
                maps = launch_kernel(L, slice_z, v_grid, u_grid, seglen,
                                     params, emission, light,
                                     stage).unbind(0)
            elif L.device.type == "cpu":
                maps = sweep_ref_fwd_reference(
                    L, slice_z, v_grid, u_grid, seglen, params,
                    emission=emission, light=light)
            else:
                raise ValueError(f"sweep: no kernel for device {L.device}")
        ctx.mark_non_differentiable(maps[3])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(L, slice_z, v_grid, u_grid, seglen, params,
                              maps[1], maps[2], light)
        ctx.emission, ctx.stage = emission, stage
        return tuple(maps)

    @staticmethod
    def backward(ctx, ct_acc, ct_trans, ct_wsum, _ct_hit):
        none = (None,) * 8
        if not any(ctx.needs_input_grad[:2]):
            return (None, None) + none
        L, slice_z, v_grid, u_grid, seglen, params, trans, wsum, light = \
            ctx.saved_tensors
        # Cotangents may arrive broadcast (the gradient of a sum), or as
        # None for a map the loss does not read; the sweep reads dense maps
        # of those its mode needs (absorption acc, emission trans and wsum).
        needed = (not ctx.emission, ctx.emission, ctx.emission)
        cts = [None if not need else torch.zeros_like(seglen) if c is None
               else c.contiguous()
               for c, need in zip((ct_acc, ct_trans, ct_wsum), needed)]
        args = (L, slice_z, v_grid, u_grid, seglen, params, *cts, trans, wsum)
        with clock.span("sweep.ref_bwd"):
            if L.device.type == "cuda":
                grads = sweep_ref_bwd.launch_kernel(
                    *args, emission=ctx.emission, light=light,
                    stage=ctx.stage)
            else:
                grads = sweep_ref_bwd.sweep_ref_bwd_reference(
                    *args, emission=ctx.emission, light=light)
        dL, dlight = grads if light is not None else (grads, None)
        dL = dL.to(ctx.in_dtypes[0])
        if dlight is not None:
            dlight = dlight.to(ctx.in_dtypes[1])
        return (dL, dlight) + none


def sweep_ref_inputs(gperm4, plan, cfg: RenderConfig, medium: MediumConfig,
                     light=None, scroll=None):
    """The kernel's inputs (L, slice_z, v_grid, u_grid, seglen, params) for
    a 4-channel grid permuted so the sweep axis is dim 0
    (grid.permute(plan.perm + (3,))) and an optional (4, 3) scroll. L is
    built per call: the scroll moves the sweep-axis lerp. Without a scroll
    the layer taps and the params depend on the plan and the configuration
    alone, and are worked out once per plan (_STILL): a fit's step builds
    only the lerp."""
    taps, params = taps_and_params(gperm4.shape[0], plan, cfg, medium, light,
                                   scroll)
    return (_lerp_channels(gperm4, *taps), plan.slice_z, plan.v_grid,
            plan.u_grid, plan.seglen, params)


def taps_and_params(depth, plan, cfg: RenderConfig, medium: MediumConfig,
                    light=None, scroll=None):
    """(_layer_taps' (layers, w), _params_ref's params) of a grid of
    `depth` layers along the sweep axis: without a scroll worked out once
    per plan and configuration (_STILL), with one per call."""
    lt = light if light is not None else LightConfig()

    def make():
        offs = _channel_offsets(medium, scroll, plan.coord_order,
                                device=plan.slice_z.device)
        return (_layer_taps(depth, plan.slice_z, medium, offs,
                            cfg.address_mode),
                _params_ref(plan, cfg, medium, lt, offs))
    if scroll is None:
        try:
            return _STILL.get((plan.slice_z, plan.eye01),
                              (depth, cfg, medium, lt), make)
        except TypeError:  # a configuration that does not hash
            pass
    return make()


def sweep_ref_light_slabs(lperm, plan, cfg: RenderConfig):
    """The kernel's (S, A, B) light slabs for a light volume permuted like
    the grid's first three dims (light_volume.permute(plan.perm)): always
    lerped onto the slice planes, so they are in slice order and there is
    no flip. Differentiable in lperm."""
    return _layer_lerp_stack(lperm, plan.slice_z, cfg.address_mode)


def sweep_base_ref(gperm4, plan, cfg: RenderConfig, medium: MediumConfig,
                   light=None, scroll=None, lperm=None):
    """(acc, trans, wsum, hit) base maps, each (Hb, Wb) float32, of the
    reference medium for a (D, A, B, 4) grid permuted so the sweep axis is
    dim 0: the kernels for a CUDA grid, the plain versions for a CPU grid,
    differentiable in the grid either way. lperm: optional (D, A, B)
    light-transmittance volume in the same layout (emission only); the
    maps are differentiable in it too. cfg.dtype "bfloat16" sweeps in the
    bfloat16 stream mode. Span "sweep.ref_layers" around the layer build."""
    if gperm4.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sweep_base_ref: no sweep for device "
                         f"{gperm4.device}")
    if lperm is not None and lperm.shape != gperm4.shape[:3]:
        raise ValueError(
            f"sweep_base_ref: the light volume must have the grid's "
            f"shape {tuple(gperm4.shape[:3])}, got {tuple(lperm.shape)}")
    with clock.span("sweep.ref_layers", device=gperm4):
        L, slice_z, v_grid, _, seglen, params = sweep_ref_inputs(
            gperm4, plan, cfg, medium, light, scroll)
        slabs = None if lperm is None else sweep_ref_light_slabs(lperm, plan,
                                                                 cfg)
    return sweep_ref_apply(L, slabs, slice_z, v_grid, seglen, params, plan,
                           cfg, medium, light)


def sweep_ref_apply(L, slabs, slice_z, v_grid, seglen, params, plan,
                    cfg: RenderConfig, medium: MediumConfig, light=None):
    """The sweep node on channel slabs L (S, 4, A, B) and optional light
    slabs (S, A, B), both in slice_z order, over the base rows v_grid (and
    their seglen) of plan; params: _params_ref's. On CUDA tensors the
    kernels, with a stage sized from the plan's own params and the medium
    (no read per scroll), once per plan, slices and rows; on CPU tensors
    the plain versions."""
    lt = light if light is not None else LightConfig()
    stage = None
    if L.device.type == "cuda":
        stage = ref_stage_for(slice_z, v_grid, plan.u_grid,
                              _params_for(plan, cfg, medium, lt),
                              L.shape[2], L.shape[3],
                              medium.channel_coord_scale, slabs is not None)
    return _SweepRef.apply(L, slabs, slice_z, v_grid, plan.u_grid, seglen,
                           params, cfg.emission, cfg.dtype == "bfloat16",
                           stage)
