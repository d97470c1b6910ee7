"""Tiled inference for huge frames. The counterpart of
`wavemamba_tpu/models/tiling.py`, with its numpy contract.

Every tile is cut at one fixed padded shape from a reflect-padded canvas (the
model sees one shape however large the frame), tiles go through the model
`tile_batch` at a time (the last batch padded by repeating its last tile),
and each tile gives back only its central `tile_size` square, computed with
`tile_pad` pixels of real (or, at the frame's border, reflected) context.
"""

from __future__ import annotations

import numpy as np


def tiled_apply(fn, img, tile_size=240, tile_pad=16, pad_multiple=8, tile_batch=8):
    """img: (1, H, W, C) numpy. fn: (B, h, w, C) numpy -> (B, h, w, C), anything
    `np.asarray` takes. Returns (1, H, W, C) numpy."""
    if img.ndim != 4 or img.shape[0] != 1:
        raise ValueError(f"tiled_apply takes one image (1, H, W, C), got {img.shape}")
    _, H, W, C = img.shape
    ts, pad = tile_size, tile_pad
    ext = ts + 2 * pad
    ext += (-ext) % pad_multiple  # one tile shape the model takes
    extra = ext - ts - 2 * pad  # absorbed into the trailing pad

    ys = list(range(0, H, ts))
    xs = list(range(0, W, ts))
    pad_bottom = ys[-1] + ts + pad + extra - H + pad
    pad_right = xs[-1] + ts + pad + extra - W + pad
    canvas = np.pad(img[0], ((pad, max(pad, pad_bottom)), (pad, max(pad, pad_right)), (0, 0)),
                    mode="reflect")
    tiles = np.stack([canvas[y0:y0 + ext, x0:x0 + ext] for y0 in ys for x0 in xs])

    outs = []
    for i in range(0, tiles.shape[0], tile_batch):
        batch = tiles[i:i + tile_batch]
        valid = batch.shape[0]
        if valid < tile_batch:  # keep the batch's shape fixed
            batch = np.concatenate([batch, np.repeat(batch[-1:], tile_batch - valid, axis=0)])
        outs.append(np.asarray(fn(batch))[:valid])
    outs = np.concatenate(outs)

    result = np.zeros((H + ts, W + ts, C), img.dtype)
    t = 0
    for y0 in ys:
        for x0 in xs:
            result[y0:y0 + ts, x0:x0 + ts] = outs[t, pad:pad + ts, pad:pad + ts]
            t += 1
    return result[None, :H, :W]


def tiled_apply_mesh(apply_fn, model, img, mesh, tile_size=240, tile_pad=16, pad_multiple=8,
                     tile_batch=None, device=None):
    """`tiled_apply` with every tile batch sharded over the mesh's ranks: each
    rank enhances its share of the batch with `apply_fn(model, x)` (x: (b, h,
    w, C) in `img`'s dtype on the model's device; `models.wavemamba_apply`,
    which on a card runs K1 in every tile), the shares are gathered in rank
    order, and
    every rank returns the whole frame, (1, H, W, C) numpy. The JAX
    package's takes (params, cfg) where the port's model carries both.

    `tile_batch` (default: the largest multiple of the ranks up to 8, at
    least one tile a rank) is rounded up to a multiple of the ranks, as in
    the JAX package. Without a mesh it is `tiled_apply` of the same
    forward. `device` (default: where the model's parameters lie) is where a
    rank's share goes; `model` is anything `apply_fn` takes (the deployment
    artifact's tile program, `deploy.ExportedModel.tiled`)."""
    import torch

    from wavemamba_torch.parallel.mesh import axis_size, gather_rows, shard_batch

    n = axis_size(mesh)
    if tile_batch is None:
        tile_batch = max(n, (8 // n) * n) if n <= 8 else n
    tile_batch = -(-tile_batch // n) * n
    if device is None:
        device = next(model.parameters()).device

    def run(tiles):
        x = torch.from_numpy(np.ascontiguousarray(shard_batch(mesh, tiles))).to(device)
        y = apply_fn(model, x)
        return gather_rows(mesh, y).flatten(0, 1).cpu().numpy()

    return tiled_apply(run, img, tile_size=tile_size, tile_pad=tile_pad,
                       pad_multiple=pad_multiple, tile_batch=tile_batch)
