# -*- coding: utf-8 -*-
"""Whole-frame and overlap-tiled sliding-window SR, on the device.

The port of ``climsr_tpu.inference.tiled``:

- :func:`pad_to_multiple` — reflect-pad a frame so H/W divide the tile grid,
- :class:`TiledSR` — cut fixed-size LR tiles with overlap, run them through
  the generator in balanced chunks, and blend the SR tiles back with a
  separable feathering window (linear ramp over the overlap; weights sum to 1),
- :func:`whole_frame_sr` — whole frames through the generator, batched over
  months.

Everything after the upload runs on the device: the LR frames go up once,
tile extraction, the generator, the blend, the overlap normalisation, the land
gather and the 12-bit packing are torch ops on the card, and
:meth:`TiledSR.device_call_many` returns a device tensor without waiting for
it. The public functions take and return NHWC arrays, as the JAX package's do.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.ops.pack12 import pack12 as pack12_fn


def pad_to_multiple(frame: np.ndarray, multiple: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflect-pad (H, W, C) on bottom/right so H, W divide ``multiple``."""
    h, w = frame.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph or pw:
        pad = [(0, ph), (0, pw)] + [(0, 0)] * (frame.ndim - 2)
        frame = np.pad(frame, pad, mode="reflect")
    return frame, (h, w)


def _feather_window(tile: int, overlap: int) -> np.ndarray:
    """Separable blending weights: linear ramps across the overlap region."""
    w1d = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = (np.arange(1, overlap + 1, dtype=np.float32)) / (overlap + 1)
        w1d[:overlap] = ramp
        w1d[-overlap:] = ramp[::-1]
    return np.outer(w1d, w1d)


def _reflect_pad_hw(t: torch.Tensor, ph: int, pw: int, h_dim: int) -> torch.Tensor:
    """Reflect-pad dims ``h_dim`` and ``h_dim + 1`` of ``t`` at the bottom/right
    (numpy's and JAX's ``mode="reflect"``: the edge pixel is not repeated)."""
    if not (ph or pw):
        return t
    lead, trail = t.shape[:h_dim], t.shape[h_dim + 2:]
    hw_last = t.movedim((h_dim, h_dim + 1), (-2, -1)).reshape((-1, 1) + tuple(t.shape[h_dim:h_dim + 2]))
    padded = F.pad(hw_last, (0, pw, 0, ph), mode="reflect")
    out = padded.reshape(tuple(lead) + tuple(trail) + tuple(padded.shape[-2:]))
    return out.movedim((-2, -1), (h_dim, h_dim + 1))


class TiledSR:
    """Overlap-tiled SR runner around a generator function.

    ``generator_fn(lr_tiles, *extra_tiles) -> sr_tiles`` takes and returns
    NHWC tensors and must accept any batch count; tile shapes are fixed at
    construction.
    """

    def __init__(
        self,
        generator_fn: Callable[..., torch.Tensor],
        scale: int,
        tile_size: int = 128,
        overlap: int = 16,
        batch_size: int = 64,
        compute_dtype: torch.dtype = torch.bfloat16,
        output_dtype: torch.dtype = torch.float32,
        post_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        pack_indices: Optional[np.ndarray] = None,
        pack12: bool = False,
        device: DeviceLike = None,
    ):
        """``post_fn(out_hw_f32, post_args) -> out_hw``: optional device-side
        postprocessing of each blended full-resolution frame (e.g.
        denormalization with per-frame min/max passed via
        ``device_call(post_args=...)``).

        ``pack_indices``: optional flat indices into the (H*s * W*s) output;
        when set, :meth:`device_call` returns ``out.ravel()[idx]`` (1-D)
        instead of the full frame — the land pixels of an ocean-masked raster.

        ``pack12`` (requires ``pack_indices``): quantize the packed vector to
        12-bit fixed point on the device (``ops/pack12.py``). The code clamps
        to (-1.5, 1.5), so it is only for the normalized output and cannot be
        combined with a ``post_fn`` that maps to physical units.
        """
        if overlap >= tile_size // 2:
            raise ValueError(f"overlap {overlap} must be < tile_size/2 ({tile_size // 2})")
        if pack12 and pack_indices is None:
            raise ValueError("pack12 packs the gathered land vector; it requires pack_indices")
        if pack12 and post_fn is not None:
            raise ValueError(
                "pack12 clamps to the normalized range (-1.5, 1.5); it cannot carry the output of a post_fn"
            )
        self.device = resolve_device(device)
        self.scale = scale
        self.tile = tile_size
        self.overlap = overlap
        self.stride = tile_size - 2 * overlap
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype
        self._gen = generator_fn
        self._post_fn = post_fn
        self._pack_idx = None if pack_indices is None else np.asarray(pack_indices, np.int64)
        self._pack12 = pack12
        hr_tile = tile_size * scale
        self._weights = torch.from_numpy(_feather_window(hr_tile, overlap * scale)).to(self.device)
        self._pack_idx_dev = None if self._pack_idx is None else torch.from_numpy(self._pack_idx).to(self.device)
        self._extras_dev: Optional[Tuple[torch.Tensor, ...]] = None
        self._static_lr_dev: Optional[torch.Tensor] = None
        self._built: Dict[tuple, Callable] = {}

    def _upload(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr)).to(device=self.device, dtype=self.compute_dtype)

    def _regular_grid(self, size: int):
        """(padded_size, origins) for a UNIFORM stride grid covering ``size``.

        The frame is reflect-padded so origins are an exact arithmetic
        sequence, which lets the blend run as 4 dense parity-group adds.
        """
        if size <= self.tile:
            return self.tile, [0]
        n_steps = -(-(size - self.tile) // self.stride)  # ceil
        padded = self.tile + n_steps * self.stride
        return padded, list(range(0, padded - self.tile + 1, self.stride))

    def set_extras(self, extras: Optional[Tuple[np.ndarray, ...]]) -> None:
        """Upload frame-invariant HR conditioning rasters (elevation, mask) once."""
        self._extras_dev = None if extras is None else tuple(self._upload(e) for e in extras)

    def set_static_lr_channels(self, chans: Optional[np.ndarray]) -> None:
        """Upload frame-invariant trailing LR input channels ONCE per series.

        The CRU-TS frames are [climate, elevation_lr, mask_lr]; only channel 0
        varies per month. With ``chans`` set to the (H, W, C-1) invariant tail,
        :meth:`device_call_many` takes the 1-channel varying frames and
        concatenates the rest on the device."""
        self._static_lr_dev = None if chans is None else self._upload(chans)

    def _build(self, h: int, w: int, k: int, has_static: bool) -> Callable:
        """The device pipeline for one (frame shape, frame-batch k):
        tiles -> generator in balanced chunks -> blend -> gather/pack."""
        hp, ys = self._regular_grid(h)
        wp, xs = self._regular_grid(w)
        origins = [(y, x) for y in ys for x in xs]
        t, s, bs = self.tile, self.scale, self.batch_size
        ht = t * s
        st = self.stride * s
        n = len(origins)
        n_y, n_x = len(ys), len(xs)
        w_const = self._weights
        # parity-group blend needs adjacent-only overlap (tile <= 2*stride)
        grouped = t <= 2 * self.stride and n > 4

        def blend_grouped(tiles_w: torch.Tensor) -> torch.Tensor:
            """(k', n, ht, ht) weighted tiles -> (k', hp*s, wp*s) accumulated canvas.

            Tiles overlap only their immediate neighbours, so the even/odd
            parity groups along each axis are internally non-overlapping: each
            group is laid out by one reshape and the four canvases are added.
            """
            kk = tiles_w.shape[0]
            G = 2 * st
            tiles_g = F.pad(tiles_w, (0, G - ht, 0, G - ht)).reshape(kk, n_y, n_x, G, G)
            out = torch.zeros((kk, hp * s + 2 * G, wp * s + 2 * G), dtype=torch.float32, device=tiles_w.device)
            for py in (0, 1):
                for px in (0, 1):
                    sub = tiles_g[:, py::2, px::2]
                    ny_p, nx_p = sub.shape[1:3]
                    if ny_p == 0 or nx_p == 0:
                        continue
                    canvas = sub.permute(0, 1, 3, 2, 4).reshape(kk, ny_p * G, nx_p * G)
                    out[:, py * st : py * st + ny_p * G, px * st : px * st + nx_p * G] += canvas
            return out[:, : hp * s, : wp * s]

        def blend_loop(tiles_w: torch.Tensor) -> torch.Tensor:
            kk = tiles_w.shape[0]
            out = torch.zeros((kk, hp * s, wp * s), dtype=torch.float32, device=tiles_w.device)
            for i, (y, x) in enumerate(origins):
                out[:, y * s : y * s + ht, x * s : x * s + ht] += tiles_w[:, i]
            return out

        blend = blend_grouped if grouped else blend_loop
        norm = blend(w_const.expand(1, n, ht, ht))[0].clamp_min(1e-8)
        pack_idx = self._pack_idx_dev
        use_pack12 = self._pack12
        post_fn = self._post_fn

        def run(frames: torch.Tensor, post_args: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
            # frames: (k, h, w, Cvar); rest = (static_lr?,) + hr_extras
            if has_static:
                static, extras = rest[0], rest[1:]
                frames = torch.cat([frames, static[None].expand((k,) + tuple(static.shape))], dim=-1)
            else:
                extras = rest
            if (hp, wp) != (h, w):  # uniform-grid reflect padding, on the device
                frames = _reflect_pad_hw(frames, hp - h, wp - w, h_dim=1)
                extras = tuple(_reflect_pad_hw(ex, (hp - h) * s, (wp - w) * s, h_dim=0) for ex in extras)
            # origin-major tile order: (n, k, t, t, C) -> (n*k, ...), so the
            # per-origin HR extras repeat k-fold in matching order
            tiles = torch.stack([frames[:, y : y + t, x : x + t] for y, x in origins])
            tiles = tiles.reshape((n * k,) + tuple(tiles.shape[2:]))
            ex_tiles = [
                torch.stack([ex[y * s : (y + t) * s, x * s : (x + t) * s] for y, x in origins]).repeat_interleave(
                    k, dim=0
                )
                for ex in extras
            ]
            nk = n * k
            # balanced chunks: m = ceil(nk/bs) generator calls of ceil(nk/m)
            # tiles (the last may be shorter) — at most bs tiles in flight,
            # in calls of near-equal size
            m = -(-nk // bs)
            cs = -(-nk // m)
            sr = torch.cat([self._gen(*(a[i : i + cs] for a in (tiles, *ex_tiles))) for i in range(0, nk, cs)])
            sr = sr[..., 0].to(torch.float32).reshape(n, k, ht, ht)
            sr = sr.transpose(0, 1) * w_const  # (k, n, ht, ht)
            out = blend(sr) / norm
            out = out[:, : h * s, : w * s]
            if post_fn is not None:
                out = torch.stack([post_fn(out[i], post_args[i]) for i in range(k)])
            if pack_idx is not None:
                out = out.reshape(k, -1)[:, pack_idx]
                if use_pack12:
                    return pack12_fn(out)
            return out.to(self.output_dtype)

        return torch.inference_mode()(run)

    def device_call(
        self,
        frame: np.ndarray,
        extras: Optional[Tuple[np.ndarray, ...]] = None,
        post_args: Tuple[float, ...] = (),
    ) -> torch.Tensor:
        """SR of one frame; returns the (H*scale, W*scale) DEVICE tensor
        without waiting for it (or the 1-D gathered vector with
        ``pack_indices``). With static LR channels set, pass only the
        VARYING channels."""
        out = self.device_call_many(
            frame[None], extras=extras, post_args=np.asarray(post_args, np.float32)[None]
        )
        return out[0]

    def device_call_many(
        self,
        frames: np.ndarray,
        extras: Optional[Tuple[np.ndarray, ...]] = None,
        post_args: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """SR of a (k, H, W[, C]) frame group in one call.

        Returns the (k, H*scale, W*scale) device tensor — or (k, n_pack) with
        ``pack_indices`` — without synchronising: the caller reads it back
        (``.cpu()``) where it needs the values.
        """
        if frames.ndim == 3:
            frames = frames[..., None]
        k = frames.shape[0]
        pre_padded = frames.shape[1] < self.tile or frames.shape[2] < self.tile
        if pre_padded:
            if self._pack_idx is not None:
                raise ValueError(
                    "pack_indices address the unpadded (H*scale, W*scale) frame; "
                    f"frame {frames.shape[1:3]} smaller than tile {self.tile} would be "
                    "pre-padded and misalign the gather"
                )
            ph, pw = (-frames.shape[1]) % self.tile, (-frames.shape[2]) % self.tile
            if ph or pw:
                frames = np.pad(frames, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = frames.shape[1:3]
        if extras is not None:
            ex_dev = tuple(self._upload(e) for e in extras)
        else:
            ex_dev = self._extras_dev or ()
        if pre_padded and ex_dev:
            # the HR extras must track the pre-padded frame exactly
            m = self.tile * self.scale
            ex_dev = tuple(_reflect_pad_hw(e, (-e.shape[0]) % m, (-e.shape[1]) % m, h_dim=0) for e in ex_dev)
        static = self._static_lr_dev
        if static is not None and tuple(static.shape[:2]) != (h, w):
            raise ValueError(f"static LR channels {tuple(static.shape[:2])} do not match the frame {(h, w)}")
        key = (h, w, frames.shape[-1], len(ex_dev), k, static is not None)
        if key not in self._built:
            self._built[key] = self._build(h, w, k=k, has_static=static is not None)
        if post_args is None:
            post_args = np.zeros((k, 0), np.float32)
        static_args = (static,) if static is not None else ()
        return self._built[key](
            self._upload(frames),
            torch.as_tensor(np.asarray(post_args, np.float32)).to(self.device),
            *static_args,
            *ex_dev,
        )

    def __call__(
        self,
        frame: np.ndarray,
        extras: Optional[Tuple[np.ndarray, ...]] = None,
        post_args: Tuple[float, ...] = (),
    ) -> np.ndarray:
        """SR one (H, W, C) frame -> (H*scale, W*scale, 1) numpy array."""
        if self._pack_idx is not None:
            raise ValueError(
                "TiledSR.__call__ returns a cropped (H*scale, W*scale, 1) frame, but "
                "pack_indices makes device_call return a packed 1-D vector — call "
                "device_call() and scatter the result yourself"
            )
        orig_hw = frame.shape[:2]
        out = self.device_call(frame, extras, post_args=post_args).float().cpu().numpy()
        return out[: orig_hw[0] * self.scale, : orig_hw[1] * self.scale, None]


def whole_frame_sr(
    generator_fn: Callable[..., torch.Tensor],
    frames: np.ndarray,
    extras: Optional[Tuple[np.ndarray, ...]] = None,
    batch_size: int = 8,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> np.ndarray:
    """Batched whole-frame SR over a (N, H, W, C) month stack -> numpy float32.

    Frame-invariant extras (elevation/mask rasters) are uploaded ONCE and
    broadcast to each batch on the device.
    """
    dev = resolve_device(device)
    ex_dev = () if extras is None else tuple(
        torch.as_tensor(np.asarray(e)).to(device=dev, dtype=compute_dtype) for e in extras
    )
    n = frames.shape[0]
    outs = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            chunk = torch.as_tensor(np.asarray(frames[start : start + batch_size])).to(device=dev, dtype=compute_dtype)
            exs = [e[None].expand((chunk.shape[0],) + tuple(e.shape)) for e in ex_dev]
            outs.append(generator_fn(chunk, *exs).float().cpu().numpy())
    return np.concatenate(outs, axis=0)
