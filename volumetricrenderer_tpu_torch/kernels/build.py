"""Build and load the port's hand-written CUDA kernels.

Each kernel is a `.cu` file under csrc/ with a plain C entry point. It is
compiled with nvcc for Hopper (sm_90a) into a shared library at first use
and loaded with ctypes. Libraries land in the package's `_build/` directory
(ignored by git), named by a hash of the source, of every header under
csrc/ that it includes, and of the flags, so an edited source or header
rebuilds and an unchanged one loads at once. Nothing here runs at
import time, and a machine without nvcc raises instead of falling back.
check_sweep_inputs is the sweep wrappers' check of their arguments before
the pointers are passed to a kernel. tile_spans, stage_texels, stage_for,
stage_buffers, stage_cap, tile_slices and TileTally are the host side of
K1's and K2's tiled schedule (csrc/sweep_tile.cuh): the tile-slice windows,
the stage they size, and the kernels' tally of tile-slices by path;
ref_tile_spans, ref_stage_texels, ref_stage_bound, ref_stage_for,
ref_stage_cap and ref_tile_slices are the same for K4's and K5's channel
windows (csrc/sweep_ref_tile.cuh). NCH,
N_PARAMS and channel_resample are
what the two 4-channel sweep modules (sweep_ref_fwd, sweep_ref_bwd) share;
light_sample is what the four plain versions share. bf16_round, stream_cast
and the ELEM_* codes belong to the bfloat16 stream mode, which
kernels/sweep_fwd.py defines.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
import weakref

import torch

from ..ops.resample import linear_resample_matrix, linear_taps

__all__ = ["NVCC_FLAGS", "build_library", "source_key",
           "check_sweep_inputs", "NCH", "N_PARAMS", "channel_resample",
           "light_sample", "bf16_round", "stream_cast", "ELEM_F32",
           "ELEM_BF16", "TILE_ROWS", "TILE_COLS", "STAGE_BYTES_MAX",
           "tile_spans", "stage_texels", "stage_for", "stage_buffers",
           "stage_cap", "tile_slices", "TileTally", "IdentityCache",
           "PLAN_CACHE_SIZE",
           "REF_MAX_SLOTS", "REF_ROUNDING", "ref_windows", "ref_tile_spans",
           "ref_stage_texels", "ref_tile_slices", "ref_stage_bound",
           "ref_stage_for", "ref_stage_cap"]

NCH = 4        # channels of the reference medium
N_PARAMS = 20  # sweep_fwd._params_for's 8, 4 coord scales, 4 b and 4 a offsets

# The C launchers' element type codes (csrc/sweep_common.cuh kElemF32,
# kElemBF16): the texel type of the stack and the light stack.
ELEM_F32, ELEM_BF16 = 0, 1
_ELEM = {torch.float32: ELEM_F32, torch.bfloat16: ELEM_BF16}

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")

# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions compute them: the tap coordinates, and so the
# in-box tests and texel indices, then agree bit for bit. No fast-math:
# parity with the plain versions is the contract.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _source_files(src: str):
    """src and every file it includes with #include "...", recursively,
    resolved against the including file's directory (as nvcc resolves
    them). System headers (<...>) are not part of the key."""
    seen, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return sorted(seen)


def source_key(src: str) -> str:
    """Hex digest over the flags and the bytes of src and of every header
    it includes: the name of its cached library."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(src):
        with open(path, "rb") as f:
            key.update(os.path.basename(path).encode() + b"\0" + f.read())
    return key.hexdigest()


def build_library(name: str):
    """Compile csrc/<name>.cu if needed and load it.

    Returns (ctypes.CDLL, info) where info holds the library path, the
    build seconds (0.0 when a cached library was loaded) and nvcc's
    output (the ptxas register and spill report)."""
    src = os.path.join(CSRC, name + ".cu")
    lib_path = os.path.join(BUILD_DIR, f"{name}-{source_key(src)[:16]}.so")
    info = {"path": lib_path, "seconds": 0.0, "log": ""}
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                + info["log"])
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path), info


def bf16_round(x):
    """x rounded to the nearest bfloat16 (ties to even) and widened back to
    float32: the value a bfloat16 stream holds."""
    return x.to(torch.bfloat16).to(torch.float32)


def stream_cast(x, low: bool):
    """x in the sweep's stream type: bfloat16 when `low` (the bfloat16
    stream mode), else float32. A tensor already in that type is returned
    as it is, without a copy."""
    if x is None:
        return None
    return x.to(torch.bfloat16 if low else torch.float32)


def check_sweep_inputs(kernel: str, stack, slice_z, v_grid, u_grid, seglen,
                       params, maps=None, channels=None, n_params=8,
                       light=None):
    """Check the arguments the sweep kernels share, plus `maps` (name ->
    (Hb, Wb) tensor) and the optional (S, A, B) `light` stack, before
    their pointers go to a kernel: CUDA, the shapes the kernel assumes,
    contiguous; `stack` and `light` float32 or bfloat16 (both of one type:
    the stream mode), everything else float32. `stack` is (S, A, B), or
    (S, channels, A, B) for the 4-channel kernels; `params` is
    (n_params,). Returns (S, A, B, Hb, Wb, elem), elem the launchers' code
    of the stack's type (ELEM_F32 or ELEM_BF16)."""
    dev = stack.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} kernel: needs CUDA tensors, got {dev}")
    lead = () if channels is None else (channels,)
    if stack.dim() != 3 + len(lead) or tuple(stack.shape[1:-2]) != lead:
        raise ValueError(
            f"{kernel} kernel: stack must be (S, "
            f"{''.join(f'{c}, ' for c in lead)}A, B), got "
            f"{tuple(stack.shape)}")
    S, (A, B) = stack.shape[0], stack.shape[-2:]
    Hb, Wb = v_grid.numel(), u_grid.numel()
    if min(S, A, B, Hb, Wb) < 1:
        raise ValueError(f"{kernel} kernel: empty input")
    named = [("stack", stack, (S, *lead, A, B)), ("slice_z", slice_z, (S,)),
             ("v_grid", v_grid, (Hb,)), ("u_grid", u_grid, (Wb,)),
             ("seglen", seglen, (Hb, Wb)), ("params", params, (n_params,))]
    named += [(k, t, (Hb, Wb)) for k, t in (maps or {}).items()]
    if light is not None:
        named.append(("light", light, (S, A, B)))
    if stack.dtype not in _ELEM:
        raise ValueError(f"{kernel} kernel: stack must be float32 or "
                         f"bfloat16, got {stack.dtype}")
    for name, t, shape in named:
        if t is None:
            raise ValueError(f"{kernel} kernel: {name} is required")
        want = stack.dtype if name in ("stack", "light") else torch.float32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{kernel} kernel: {name} must be a contiguous {want} "
                f"tensor on {dev}; got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel} kernel: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    return S, A, B, Hb, Wb, _ELEM[stack.dtype]


def channel_resample(a01, b01, params, c, A, B, low=False):
    """Channel c's banded tap matrices on one slice of the 4-channel
    sweep: (Wa (Hb, A), Wb (Wb, B)) at the scaled and scrolled coords
    a01 * sc + offa and b01 * sc + offb with mirror addressing. Wa's rows
    are zeroed where the unscaled a01 leaves [0, 1]: the box test comes from
    the ray, the mirror applies to the texture coordinate only. low: the
    bfloat16 stream mode, each tap weight rounded to bfloat16."""
    sc = params[8 + c]
    inr = ((a01 >= 0.0) & (a01 <= 1.0)).to(torch.float32)
    Wa = linear_resample_matrix(a01 * sc + params[16 + c], A, "mirror",
                                round_bf16=low) * inr[:, None]
    Wbm = linear_resample_matrix(b01 * sc + params[12 + c], B, "mirror",
                                 round_bf16=low)
    return Wa, Wbm


def light_sample(layer, a01, b01, address_mode, low=None):
    """The plain versions' bilinear sample lT of an (A, B) light layer at
    rows a01 (Hb,) and columns b01 (Wb,): (Hb, Wb), differentiable in the
    layer.

    It takes the four taps explicitly and sums them in the kernels' order
    (sweep_common.cuh bilinear_at), not as two banded matmuls like sigma:
    lT feeds the clip to [0, 1], whose subgradient jumps at the bounds
    (1, 0.5 at a tie, 0), and a fully lit region has lT = 1.0 exactly or to
    within an ulp. A sample that rounds to 1.0 in one summation order and
    to 1 - 2^-24 in another would halve that sample's share of dL; summed
    in one order, kernel and plain version decide every tie on the same
    float.

    A bfloat16 layer is the bfloat16 stream mode: its texels are widened
    and the four weights are each rounded to bfloat16, as the kernels round
    them. They then sum to 1 only to within 2^-8, so a fully lit
    neighbourhood samples just above or just below 1, sample by sample,
    and only the same weights in the same order decide each alike. low=True
    forces that mode's weights on a float32 layer (the plain forwards'
    private `_low`)."""
    A, B = layer.shape
    if low is None:
        low = layer.dtype == torch.bfloat16
    layer = layer.to(torch.float32)
    a0, a1, wa0, wa1 = linear_taps(a01, A, address_mode, round_bf16=low)
    b0, b1, wb0, wb1 = linear_taps(b01, B, address_mode, round_bf16=low)
    r0, r1 = layer.index_select(0, a0), layer.index_select(0, a1)
    wa0, wa1, wb0, wb1 = wa0[:, None], wa1[:, None], wb0[None, :], wb1[None, :]
    return (wa0 * (wb0 * r0.index_select(1, b0) + wb1 * r0.index_select(1, b1))
            + wa1 * (wb0 * r1.index_select(1, b0)
                     + wb1 * r1.index_select(1, b1)))


# K1's and K2's tile (csrc/sweep_tile.cuh kRows, kCols) and the most dynamic
# shared memory a launch may take for its windows (the card allows 227 KB a
# block; more than 48 KB is opted into at launch).
TILE_ROWS, TILE_COLS = 32, 32
STAGE_BYTES_MAX = 96 * 1024


# Plans a caller may keep and reuse (serve.py keeps this many on its
# lattice): the per-plan caches of the launchers hold as many, so a reused
# plan's launch reads nothing back from the device.
PLAN_CACHE_SIZE = 512


class IdentityCache:
    """Values computed from tensors, kept while those very tensors live:
    the key is their identity plus hashable extras, checked through weak
    references so a freed tensor's reused id never matches. The sweep plan's
    arrays are never written in place, so a value computed from them stays
    right. Holds at most `size` entries, dropping the oldest."""

    def __init__(self, size=PLAN_CACHE_SIZE):
        self._entries, self._size = {}, size

    def get(self, tensors, extra, make):
        key = (tuple(id(t) for t in tensors), extra)
        hit = self._entries.get(key)
        if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
            return hit[1]
        value = make()
        if len(self._entries) >= self._size:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = (tuple(weakref.ref(t) for t in tensors), value)
        return value


def _unit_ends(e, delta, q, tile):
    """The coordinate e + delta * q of every tile's first and last line on
    every slice, in the kernels' float32 expressions, clamped to the box:
    (lo, hi, any), each (tiles, S); any: a line of the tile can be in the
    box."""
    length = q.shape[0]
    first = torch.arange(0, length, tile, device=q.device)
    last = torch.clamp(first + tile, max=length) - 1
    x0 = e + delta[None, :] * q[first][:, None]
    x1 = e + delta[None, :] * q[last][:, None]
    lo, hi = torch.minimum(x0, x1), torch.maximum(x0, x1)
    any_in = (hi >= 0.0) & (lo <= 1.0)
    return torch.clamp(lo, 0.0, 1.0), torch.clamp(hi, 0.0, 1.0), any_in


def _axis_spans(e, delta, q, n, wrap, tile):
    """sweep_tile.cuh axis_span for every tile of one axis and every slice:
    (lo, hi, any), each (tiles, S). The float32 expressions of the kernel,
    on the tile's first and last line."""
    lo, hi, any_in = _unit_ends(e, delta, q, tile)
    t_lo = torch.floor(lo * n - 0.5).to(torch.int64)
    t_hi = torch.floor(hi * n - 0.5).to(torch.int64) + 1
    if not wrap:
        t_lo, t_hi = t_lo.clamp(0, n - 1), t_hi.clamp(0, n - 1)
    return t_lo, t_hi, any_in


def tile_spans(slice_z, v_grid, u_grid, params, A, B, wrap):
    """The tile-slice windows of K1's and K2's schedule, as the kernels
    compute them (sweep_tile.cuh next_window), on the tensors' device.

    Returns (front, rows, cols): front (S,) bool, the slices in front of the
    eye; rows = (lo, hi, any), each (ceil(Hb / TILE_ROWS), S): the window's
    texel-row range [lo, hi] (clipped for mirror and clamp, unwrapped for
    wrap, where it is read modulo A) and whether a row of the tile can be in
    the box; cols the same for the columns and B. A tile-slice is active
    (inside the tile's slice range) when front & rows.any & cols.any; its
    window is rows.hi - rows.lo + 1 by cols.hi - cols.lo + 1 texels."""
    e_k, e_a, e_b, sign = (params[n] for n in range(4))
    delta = slice_z - e_k
    front = delta * sign > 0.0
    return (front, _axis_spans(e_a, delta, v_grid, A, wrap, TILE_ROWS),
            _axis_spans(e_b, delta, u_grid, B, wrap, TILE_COLS))


def _extents(span):
    lo, hi, any_in = span
    return torch.where(any_in, hi - lo + 1, torch.zeros_like(lo))


def stage_texels(spans) -> int:
    """The largest window, in texels, of any active tile-slice of
    tile_spans' result: the stage that holds every window of the plan."""
    front, rows, cols = spans
    need = _extents(rows).amax(0) * _extents(cols).amax(0)
    return int(torch.where(front, need, torch.zeros_like(need)).max())


_STAGES = IdentityCache()


def stage_for(slice_z, v_grid, u_grid, params, A, B, wrap) -> int:
    """stage_texels of these plan tensors, computed once per set of tensors
    (the computation ends in a read to the host; a plan reused for many
    frames pays it once)."""
    return _STAGES.get(
        (slice_z, v_grid, u_grid, params), (A, B, bool(wrap)),
        lambda: stage_texels(tile_spans(slice_z, v_grid, u_grid, params, A,
                                        B, wrap)))


def stage_buffers(backward: bool, light: bool) -> int:
    """The window buffers of `cap` float slots a launch takes besides its
    window table (csrc/sweep_fwd.cu, sweep_bwd.cu): two staged windows per
    volume (the stack's, and the light stack's), K1 and K2 alike
    (`backward` changes nothing): K2 adds its sums straight to global
    memory, so the stage holds only what it reads."""
    return (2 if light else 1) * 2


def stage_cap(texels: int, buffers: int) -> int:
    """The stage a launch takes: `texels` slots per window buffer, at most
    what STAGE_BYTES_MAX allows for `buffers` buffers of 4-byte slots. A
    tile-slice whose window is larger reads through global memory."""
    return max(0, min(int(texels), STAGE_BYTES_MAX // (4 * buffers)))


def tile_slices(spans, cap: int):
    """(active, global): the active tile-slices of tile_spans' result, and
    of those the ones whose window exceeds `cap` texels and so read through
    global memory. With no ray ending early (absorption) a kernel's tally
    equals `active`."""
    front, rows, cols = spans
    r, c = _extents(rows), _extents(cols)
    area = r[:, None, :] * c[None, :, :] * front[None, None, :]
    active = area > 0
    return int(active.sum()), int((active & (area > cap)).sum())


# K4's and K5's windows (csrc/sweep_ref_tile.cuh): one per channel, and
# the light slabs' (K1's clipped window) as a fifth; the most slots a
# tile-slice's windows may stage together (64 a thread, kMaxSlots).
REF_MAX_SLOTS = 64 * 256
# The float32 rounding of a channel coordinate, in texels, that the
# offset-free stage bound allows for (ref_stage_bound).
REF_ROUNDING = 1.0 / 16.0


def ref_windows(light: bool) -> int:
    """Windows per tile-slice of K4 and K5: NCH, and the light's."""
    return NCH + (1 if light else 0)


def _chan_tap(x, sc, off, n):
    """sweep_ref_common.cuh chan_tap: the unmirrored tap floor((x * sc +
    off) * n - 0.5), in the kernel's float32 expressions."""
    return torch.floor((x * sc + off) * n - 0.5).to(torch.int64)


def ref_tile_spans(slice_z, v_grid, u_grid, params, A, B):
    """The channel windows of K4's and K5's tiled schedule, as the kernels
    compute them (sweep_ref_tile.cuh fill_windows), on the tensors' device.

    params is the (N_PARAMS,) vector of the sweep (the scroll's offsets
    included). Returns (front, rows, cols): front (S,) bool, the slices in
    front of the eye; rows = (lo, hi, any): lo and hi (NCH, ceil(Hb /
    TILE_ROWS), S) int64, channel c's unmirrored texel-row range [lo, hi]
    of each tile-slice (slot m of the window holds texel
    mirror(lo + m)), any (tiles, S) whether a row of the tile can be in
    the box (the unscaled coordinate: the box test is the ray's); cols the
    same for the columns, B and the b offsets. The light window is K1's
    (tile_spans with clipping)."""
    e_k, e_a, e_b, sign = (params[n] for n in range(4))
    delta = slice_z - e_k
    front = delta * sign > 0.0

    def axis(e, q, n, tile, off_at):
        lo, hi, any_in = _unit_ends(e, delta, q, tile)
        los, his = [], []
        for c in range(NCH):
            sc, off = params[8 + c], params[off_at + c]
            t0, t1 = _chan_tap(lo, sc, off, n), _chan_tap(hi, sc, off, n)
            los.append(torch.minimum(t0, t1))
            his.append(torch.maximum(t0, t1) + 1)
        return torch.stack(los), torch.stack(his), any_in

    return (front, axis(e_a, v_grid, A, TILE_ROWS, 16),
            axis(e_b, u_grid, B, TILE_COLS, 12))


def _ref_areas(spans, light_spans=None):
    """(active (tiles_r, tiles_c, S) bool, windows (W, tiles_r, tiles_c,
    S) int64): the tile-slices in their tiles' slice ranges and the slots
    of each of their windows, channels first, then the light's."""
    front, (rlo, rhi, rany), (clo, chi, cany) = spans
    active = front[None, None, :] & rany[:, None, :] & cany[None, :, :]
    areas = (rhi - rlo + 1)[:, :, None, :] * (chi - clo + 1)[:, None, :, :]
    if light_spans is not None:
        _, rows, cols = light_spans
        r, c = _extents(rows), _extents(cols)
        areas = torch.cat([areas, (r[:, None, :] * c[None, :, :])[None]])
    return active, areas


def ref_stage_texels(spans, light_spans=None) -> int:
    """The largest window, in slots, of any active tile-slice of
    ref_tile_spans' result (and of tile_spans' light windows, if given):
    the stage that holds every window of this sweep."""
    active, areas = _ref_areas(spans, light_spans)
    return int(torch.where(active[None], areas,
                           torch.zeros_like(areas)).max())


def ref_tile_slices(spans, cap: int, light_spans=None):
    """(active, global): the active tile-slices of ref_tile_spans' result,
    and of those the ones with a window (a channel's, or the light's if
    light_spans is given) larger than `cap` slots, which read through
    global memory. With no ray ending early, a kernel's tally."""
    active, areas = _ref_areas(spans, light_spans)
    over = (areas > cap).any(0)
    return int(active.sum()), int((active & over).sum())


def ref_stage_bound(slice_z, v_grid, u_grid, params, scales, A, B,
                    light: bool) -> int:
    """A stage, in slots, that holds every window of K4 and K5 on this plan
    whatever the scroll's offsets: from the plan (params[:4]) and the
    channels' coordinate scales only.

    A channel's window spans the taps floor(P) of the coordinates of a
    tile's first and last line clamped to the box, x0 <= x1, P = (x * sc +
    off) * n - 0.5, plus one: t1 - t0 + 2 slots for the ordered taps. As
    floor(a) - floor(b) <= ceil(a - b), that is at most ceil(|P1 - P0|) + 2
    <= floor(d + E) + 3, where d = (x1 - x0) * |sc| * n is the scaled span
    and E is the float32 rounding of P1 - P0 against d. E grows with
    |q| = |x * sc + off|; it stays below REF_ROUNDING (1/16 texel) while
    |q| * n < 2^16 (|q| below ~500 at n = 128). So a window has at most
    floor(d + 1/16) + 3 slots along each axis, whatever off is; beyond that
    range a window may be larger, and reads through global memory (the
    kernels count it). With light, the light window (K1's, offset-free)
    too. One read to the host."""
    e_k, e_a, e_b, sign = (params[n] for n in range(4))
    delta = slice_z - e_k
    front = delta * sign > 0.0
    sc = torch.tensor(scales, dtype=torch.float32).abs().to(torch.float64)

    def extents(e, q, n, tile):
        lo, hi, any_in = _unit_ends(e, delta, q, tile)
        d = (hi.to(torch.float64) - lo.to(torch.float64))[None] \
            * sc.to(q.device)[:, None, None] * n
        ext = torch.floor(d + REF_ROUNDING).to(torch.int64) + 3
        return torch.where(any_in[None], ext, torch.zeros_like(ext))

    need = (extents(e_a, v_grid, A, TILE_ROWS).amax(1)
            * extents(e_b, u_grid, B, TILE_COLS).amax(1)).amax(0)
    if light:
        _, rows, cols = tile_spans(slice_z, v_grid, u_grid, params, A, B,
                                   False)
        need = torch.maximum(need, _extents(rows).amax(0)
                             * _extents(cols).amax(0))
    return int(torch.where(front, need, torch.zeros_like(need)).max())


_REF_STAGES = IdentityCache()


def ref_stage_for(slice_z, v_grid, u_grid, params, A, B, scales=None,
                  light=False) -> int:
    """ref_stage_bound, computed once per set of these tensors and scales
    (the computation ends in a read to the host). The bound reads only
    params[:4], the plan's, so the sweep passes its per-plan (8,) params
    and the medium's scales: every frame of a plan then finds the stage
    here, whatever its scroll. scales None: params[8:12] (a host read)."""
    if scales is None:
        scales = tuple(params[8:8 + NCH].tolist())
    return _REF_STAGES.get(
        (slice_z, v_grid, u_grid, params),
        (A, B, tuple(float(x) for x in scales), bool(light)),
        lambda: ref_stage_bound(slice_z, v_grid, u_grid, params, scales, A,
                                B, light))


def ref_stage_cap(texels: int, backward: bool, light: bool) -> int:
    """The stage a K4 or K5 launch takes, in slots per window buffer:
    stage_cap of its buffers (two staged windows per window, K5 also one
    accumulation window per warp and window), and at most REF_MAX_SLOTS
    over its windows."""
    nw = ref_windows(light)
    buffers = nw * (2 + (8 if backward else 0))
    return min(stage_cap(texels, buffers), REF_MAX_SLOTS // nw)


class TileTally:
    """A kernel's tally of tile-slices on each device, (computed, read
    through global memory), added to by every launch (the C launchers'
    `counts`). read() sums the devices (a read to the host); reset() zeroes
    them."""

    def __init__(self):
        self._counts = {}

    def tensor(self, device):
        t = self._counts.get(device)
        if t is None:
            t = self._counts[device] = torch.zeros(2, dtype=torch.int64,
                                                   device=device)
        return t

    def read(self):
        done = glob = 0
        for t in self._counts.values():
            d, g = (int(x) for x in t.tolist())
            done, glob = done + d, glob + g
        return done, glob

    def reset(self):
        for t in self._counts.values():
            t.zero_()
