"""Fused MBConv serving kernels: [expand 1×1 → silu →] depthwise K×K → silu,
plus the squeeze-excite global mean pool from the same pass.

Counterpart of ``multimodal_isic_tpu/ops/fused_dwconv.py``.  The two public
functions keep its layouts (NHWC activations, depthwise weights
``[K, K, 1, C]``, expand weights ``[Cin, Cmid]`` or ``[1, 1, Cin, Cmid]``) and
return ``(y in x.dtype, pool [B, C] float32)``; there is no row-tile or
interpret argument.  The kernels read weights in PyTorch's conv layouts, so
the model's views of its OIHW parameters reach them without a copy.

- On a CUDA tensor each launches its hand-written kernel from
  ``csrc/fused_dwconv.cu`` (built with nvcc at first use, see ``_build``), or
  raises: there is no fallback.
- On a CPU tensor each runs its plain PyTorch version
  (``*_reference``), which the tests hold against the JAX package and which
  the card's smoke run holds the kernels against.

The TPU VMEM fit model (``pick_row_tile_*``, ``fits_pallas_*``) has no
counterpart.  The wrapper owns the card's launch plan (:func:`mbconv_plan`:
channel chunk, row tile or band, shared memory), which the kernel checks
against its own layout; every stride-1 block of the serving forward takes a
kernel.  Each call is one launch: y and the pool come from ``torch.empty``
(the kernel writes every entry, the pool in the same order on every run).

Neither kernel has a backward, as the JAX kernels have no VJP: each wrapper
raises when grad mode is on and an input requires grad, on every device, and
returns a result off the autograd graph only under ``torch.no_grad`` /
``torch.inference_mode`` or when no input requires grad.  (The serving path
runs under inference mode; training takes the unfused blocks.)

Each wrapper counts its kernel launches in ``<function>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .depthwise import depthwise_conv2d

KERNEL_SIZES = (3, 5)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_BATCH = 65535  # gridDim.z

# The card's kernels (csrc/fused_dwconv.cu; its constants of the same names)
MAX_SMEM = 232448      # shared memory a block may have on the H100
TWO_BLOCKS = 115712    # a block's share when two share an SM (228 KB less 1 KB each)
SMS = 132              # the H100's SMs
_THREADS, _CC, _MG, _BK, _STAGES, _DEPTH = 256, 64, 128, 32, 3, 3


# ----------------------------------------------------------- plain versions

def dw_silu_pool_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Plain version of :func:`dw_silu_pool`, with the kernel's casts: taps
    multiply in f32 on values read in x.dtype, bias and silu in f32, y cast
    to x.dtype, pool from the f32 activations."""
    h, ww = x.shape[1], x.shape[2]
    act = F.silu(depthwise_conv2d(x.float(), w.float(), bias=b.float()))
    return (act.to(x.dtype).contiguous(),
            act.sum(dim=(1, 2)) * (1.0 / (h * ww)))


def expand_dw_silu_pool_reference(x: torch.Tensor, we: torch.Tensor,
                                  be: torch.Tensor, wd: torch.Tensor,
                                  bd: torch.Tensor):
    """Plain version of :func:`expand_dw_silu_pool`: the expand product in
    f32, + be, silu, rounded to x.dtype, then :func:`dw_silu_pool_reference`
    (whose SAME zero padding applies after the expand, as in the unfused
    graph)."""
    we2 = we.reshape(x.shape[-1], -1)
    e = torch.einsum("bhwc,cd->bhwd", x.float(), we2.float()) + be.float()
    return dw_silu_pool_reference(F.silu(e).to(x.dtype), wd, bd)


# ---------------------------------------------------------- the launch plan

def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def expand_smem_bytes(tile: int, w: int, k: int, cin: int, esz: int,
                      cc: int = _CC) -> int:
    """Shared memory of one expand block (the kernel's ``ExpandSmem``): the
    halo buffer [tile + K - 1][W + K - 1][cc], the weight chunk [cc][Cin to
    a multiple of the k-slice, + pad], the 3-stage ring [128][k-slice +
    pad] (k-slice 32, 64 at cc 128) and the pool's 8 slot sums of cc
    channels, in bytes of ``esz``-byte elements."""
    p, pad = (k - 1) // 2, 8 if esz == 2 else 4
    bk = 2 * _BK if cc == 2 * _CC else _BK
    kp = -(-cin // bk) * bk
    return (_a16((tile + 2 * p) * (w + 2 * p) * cc * esz)
            + _a16(cc * (kp + pad) * esz)
            + _a16(_STAGES * _MG * (bk + pad) * esz)
            + 8 * cc * 4 + 16)


def dw_smem_bytes(cc: int, w: int, k: int, esz: int) -> int:
    """Shared memory of one dw block (the kernel's ``DwSmem``): K + 3 row
    buffers [W + K - 1][cc] and the pool's slot sums."""
    p = (k - 1) // 2
    return (_a16((w + 2 * p) * cc * esz) * (k + _DEPTH)
            + _THREADS // (cc // 2) * cc * 4 + 16)


@functools.cache
def mbconv_plan(b: int, h: int, w: int, cin: int, cmid: int, k: int,
                dtype: torch.dtype, expand: bool = True) -> dict:
    """The card's launch plan for one call on [b, h, w, cin] → cmid channels
    (``expand=False``: the dw kernel, cin == cmid).

    - ``cc``: channels a block.  Expand: 128 in bf16 (512 threads, one
      block an SM: x is read Cmid/128 times) where rounding Cmid up to 128
      wastes at most an eighth of it and one block covers the image (no
      halo rows computed twice, the pool written directly), else 64 (256
      threads, two blocks an SM); dw: up to 64, halved until the row ring
      fits;
    - ``rows`` and ``n_tiles``: output rows a block and blocks along H,
      covering H once (the last may be short).  Expand: the tallest tile
      whose block fits its share of the SM (``TWO_BLOCKS`` at cc 64, or
      ``MAX_SMEM`` where that leaves fewer than 4 rows; ``MAX_SMEM`` at cc
      128); then evened out over the same tile count.  dw:
      bands that give the nearest whole number of blocks to two an SM across
      the batch, of at least 4 rows (each band reads K - 1 halo rows again);
    - ``n_chunks``, ``smem`` (bytes; the kernel refuses any other) and
      ``pool``: "direct" where one block covers its image's rows, else
      "partials" (float32 partial sums [n_tiles, b, cmid], added in tile
      order by the last block of each (image, chunk)).

    Raises ``ValueError`` where no block fits the card's shared memory."""
    esz = torch.finfo(dtype).bits // 8
    if expand:
        if esz == 2 and -(-cmid // (2 * _CC)) * 2 * _CC - cmid <= cmid // 8:
            try:
                plan = _expand_plan(h, w, cin, cmid, k, esz, 2 * _CC)
                if plan["n_tiles"] == 1:
                    return plan
            except ValueError:
                pass
        return _expand_plan(h, w, cin, cmid, k, esz, _CC)
    cc, vec = min(cmid, _CC), 16 // esz
    while dw_smem_bytes(cc, w, k, esz) > MAX_SMEM and cc > vec:
        cc = max(vec, cc // 2 // vec * vec)
    n_chunks = -(-cmid // cc)
    bands = min(h, max(1, round(2 * SMS / (b * n_chunks))))
    rows = max(min(h, 4), -(-h // bands))

    def size(t):
        return dw_smem_bytes(cc, w, k, esz)

    if size(rows) > MAX_SMEM:
        rows = 0
    return _finish_plan(h, cmid, cc, rows, size)


def _expand_plan(h: int, w: int, cin: int, cmid: int, k: int, esz: int,
                 cc: int) -> dict:
    """The expand plan at channel chunk ``cc`` (64: 256 threads, tiles that
    fit two blocks an SM unless that leaves fewer than 4 rows; 128: 512
    threads, one block an SM)."""
    def size(t):
        return expand_smem_bytes(t, w, k, cin, esz, cc)

    fits = (lambda t: size(t) <= TWO_BLOCKS) if cc == _CC else \
        (lambda t: size(t) <= MAX_SMEM)
    rows = max((t for t in range(1, h + 1) if fits(t)), default=0)
    if cc == _CC and rows < min(h, 4):
        rows = max((t for t in range(1, h + 1) if size(t) <= MAX_SMEM),
                   default=0)
    return _finish_plan(h, cmid, cc, rows, size)


def _finish_plan(h: int, cmid: int, cc: int, rows: int, size) -> dict:
    if rows == 0:
        raise ValueError(f"fused MBConv kernel: no block of {h} rows and a "
                         f"{cc}-channel chunk fits {MAX_SMEM} bytes of "
                         "shared memory")
    n_tiles = -(-h // rows)
    rows = -(-h // n_tiles)
    return {"cc": cc, "rows": rows, "n_tiles": n_tiles,
            "n_chunks": -(-cmid // cc), "smem": size(rows),
            "pool": "direct" if n_tiles == 1 else "partials"}


# ------------------------------------------------------------- the kernels

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_dwconv")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"dw_silu_pool_{sfx}")
        fn.argtypes, fn.restype = [vp] * 7 + [i32] * 9 + [i64, vp], i32
        fn = getattr(lib, f"expand_dw_silu_pool_{sfx}")
        fn.argtypes, fn.restype = [vp] * 9 + [i32] * 10 + [i64, vp], i32
    lib.fused_dwconv_error_string.argtypes = [i32]
    lib.fused_dwconv_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _entry(name: str, dtype: torch.dtype):
    """The C entry ``<name>_<dtype>``, looked up once."""
    return getattr(_lib(), f"{name}_{_SUFFIX[dtype]}")


_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """n int32 arrival counters for the pool's partials on (device, stream):
    zeroed once when allocated (or grown); every launch leaves them zero."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _check(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, c: int):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    k = wd.shape[0]
    if k not in KERNEL_SIZES or tuple(wd.shape) != (k, k, 1, c):
        raise ValueError(f"depthwise weight must be [K, K, 1, {c}] with K in "
                         f"{KERNEL_SIZES}, got {tuple(wd.shape)}")
    if tuple(bd.shape) != (c,):
        raise ValueError(f"depthwise bias must be [{c}], got {tuple(bd.shape)}")


def _no_backward(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (neither has the JAX kernel): call it "
            "under torch.no_grad() or torch.inference_mode(), or with inputs "
            "that do not require grad")


def _kernel_weights(x: torch.Tensor, wd: torch.Tensor, biases):
    """The kernel's operand layouts: depthwise [C, K*K] in x.dtype and the
    biases as they are when both are f32 or both bf16 (else f32), with the
    flag that tells the kernel which.  Where ``wd`` is the ``permute(2, 3,
    1, 0)`` view of an OIHW parameter in x.dtype and the biases contiguous,
    as in the model, the tensors are passed as they are: their memory has
    the kernel's layout, and no tensor op is dispatched (the serving forward
    at bs 16 is host-bound)."""
    k, c = wd.shape[0], wd.shape[-1]
    if wd.dtype == x.dtype and wd.stride() == (k, 1, k * k, k * k):
        wk = wd
    else:
        wk = wd.permute(3, 2, 0, 1).reshape(c, k * k).to(x.dtype).contiguous()
    dt = biases[0].dtype
    if dt not in _SUFFIX or any(b.dtype != dt for b in biases):
        dt = torch.float32
    return wk, [b if b.dtype == dt and b.stride() == (1,) else
                b.to(dt).contiguous() for b in biases], int(dt == torch.bfloat16)


def _launch(name: str, x: torch.Tensor, tensors, ints, cin: int, c: int,
            k: int):
    """Allocate y and the pool (``torch.empty``: the kernel writes every
    entry), take :func:`mbconv_plan`, launch ``<name>_<dtype>`` on the
    current stream, raise on a refused launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA "
                         f"device, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC (an NCHW tensor "
                         "needs torch.channels_last and a permute)")
    if x.shape[0] > _MAX_BATCH:
        raise ValueError(f"{name}: batch {x.shape[0]} > {_MAX_BATCH}")
    vec = 16 // x.element_size()  # the kernel moves 16 bytes at a time
    if x.shape[-1] % vec or c % vec or x.data_ptr() % 16:
        raise ValueError(f"{name}: channel counts must be multiples of {vec} "
                         f"for {x.dtype} and x 16-byte aligned, got "
                         f"{x.shape[-1]} -> {c}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}")
    bsz, h, w = x.shape[:3]
    plan = mbconv_plan(bsz, h, w, cin, c, k, x.dtype,
                       name == "expand_dw_silu_pool")
    y = torch.empty((bsz, h, w, c), dtype=x.dtype, device=x.device)
    pool = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial = counters = None
        if plan["n_tiles"] > 1:
            partial = torch.empty((plan["n_tiles"], bsz, c),
                                  dtype=torch.float32, device=x.device)
            counters = _counters(x.device, stream, bsz * plan["n_chunks"])
        rc = _entry(name, x.dtype)(
            *(t.data_ptr() for t in (x, *tensors, y, pool)),
            *(None if t is None else t.data_ptr()
              for t in (partial, counters)),
            *ints, plan["cc"], plan["rows"], plan["n_tiles"], plan["smem"],
            stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_lib().fused_dwconv_error_string(rc).decode()}")
    return y, pool


def dw_silu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Stride-1 SAME depthwise conv + bias + silu + global mean.

    x [B, H, W, C] (float32 or bfloat16), w [K, K, 1, C], b [C] →
    (y [B, H, W, C] in x.dtype, pool [B, C] float32), ``pool`` being the mean
    of the f32 activations before their cast.
    """
    c = x.shape[-1]
    _check(x, w, b, c)
    _no_backward("dw_silu_pool", x, w, b)
    if x.device.type == "cpu":
        return dw_silu_pool_reference(x, w, b)
    bsz, h, ww = x.shape[:3]
    wk, (bk,), bias_bf16 = _kernel_weights(x, w, [b])
    out = _launch("dw_silu_pool", x, (wk, bk),
                  (bsz, h, ww, c, w.shape[0], bias_bf16), c, c, w.shape[0])
    dw_silu_pool.launches += 1
    return out


def expand_dw_silu_pool(x: torch.Tensor, we: torch.Tensor, be: torch.Tensor,
                        wd: torch.Tensor, bd: torch.Tensor):
    """silu(x @ we + be) → stride-1 SAME depthwise(wd) + bd → silu → pool.

    x [B, H, W, Cin], we [1, 1, Cin, Cmid] or [Cin, Cmid], be [Cmid],
    wd [K, K, 1, Cmid], bd [Cmid] → (y [B, H, W, Cmid] in x.dtype,
    pool [B, Cmid] float32).  The [H, W, Cmid] expand output exists only in
    the kernel's shared memory.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if tuple(we.shape[:-1]) not in ((cin,), (1, 1, cin)):
        raise ValueError(f"expand weight must be [{cin}, Cmid] or "
                         f"[1, 1, {cin}, Cmid], got {tuple(we.shape)}")
    we2 = we if we.dim() == 2 else we.reshape(cin, -1)
    cmid = we2.shape[1]
    _check(x, wd, bd, cmid)
    if tuple(be.shape) != (cmid,):
        raise ValueError(f"expand bias must be [{cmid}], got {tuple(be.shape)}")
    _no_backward("expand_dw_silu_pool", x, we, be, wd, bd)
    if x.device.type == "cpu":
        return expand_dw_silu_pool_reference(x, we2, be, wd, bd)
    bsz, h, ww = x.shape[:3]
    wk, (bek, bdk), bias_bf16 = _kernel_weights(x, wd, [be, bd])
    # [Cmid, Cin]: the conv parameter itself when ``we`` is its transpose
    wek = (we2 if we2.dtype == x.dtype and we2.stride() == (1, cin) else
           we2.t().to(x.dtype).contiguous())
    out = _launch("expand_dw_silu_pool", x, (wek, bek, wk, bdk),
                  (bsz, h, ww, cin, cmid, wd.shape[0], bias_bf16), cin, cmid,
                  wd.shape[0])
    expand_dw_silu_pool.launches += 1
    return out


dw_silu_pool.launches = 0
expand_dw_silu_pool.launches = 0
