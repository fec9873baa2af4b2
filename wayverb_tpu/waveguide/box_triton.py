"""The fused shoebox step (``box_fused._jnp_forward``'s field part) as one
Pallas kernel through Triton, for NVIDIA GPUs.

One program per (x, y-tile): it loads the tile's z rows of ``cur`` and its
six neighbour views (±x, ±y from the adjacent rows, ±z by shifted loads),
applies the point-source injection to every view, computes the masked
stencil, splices the six boundary planes in writer order (y, z, x) and
stores the tile.  Every element of ``cur`` and ``prev`` is read from device
memory once per step when neighbouring programs hit in cache, and the
output is written once: the 12 B/node model.  The inner-plane extraction
stays outside (six thin slices of the output).

Parity oracle: ``box_fused._jnp_forward`` (identical arithmetic order per
element: λ²·(Σ neighbours) − prev).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from wayverb_tpu.waveguide.descriptor import COURANT_SQ

TILE_Y = 8          # y rows per program; z is one power-of-two block


def _kernel(geom_ref, inj_ref, injv_ref, cur_ref, prev_ref, hlo_ref, hhi_ref,
            pxlo_ref, pxhi_ref, pylo_ref, pyhi_ref, pzlo_ref, pzhi_ref,
            out_ref, *, X, Y, Z, ZP):
    i = pl.program_id(0)
    j = pl.program_id(1)
    ys = j * TILE_Y + jnp.arange(TILE_Y)
    zs = jnp.arange(ZP)
    yc = ys[:, None]
    zc = zs[None, :]
    inb = (yc < Y) & (zc < Z)
    g = [geom_ref[k] for k in range(9)]
    sx, sy, sz, mode = (inj_ref[k] for k in range(4))
    v_now = injv_ref[0]
    v_prev = injv_ref[1]

    def inject(block, x, yy, zz, value):
        oh = ((g[0] + x == sx) & (g[1] + yy == sy) & (g[2] + zz == sz)
              & (mode > 0))
        return jnp.where(oh, jnp.where(mode == 1, value, block + value),
                         block)

    def cur_at(x, yy, zz, mask):
        blk = plgpu.load(cur_ref.at[x, yy, zz], mask=mask, other=0.0)
        return inject(blk, x, yy, zz, v_now)

    ns = cur_at(i - 1, yc, zc, inb & (i > 0))
    ns += cur_at(i + 1, yc, zc, inb & (i < X - 1))
    ns += cur_at(i, yc - 1, zc, inb & (yc > 0))
    ns += cur_at(i, yc + 1, zc, inb & (yc < Y - 1))
    ns += cur_at(i, yc, zc - 1, inb & (zc > 0))
    ns += cur_at(i, yc, zc + 1, inb & (zc < Z - 1))
    # shard halos: the −x neighbour of local row 0, the +x of row X−1
    ns += plgpu.load(hlo_ref.at[0, yc, zc], mask=inb & (i == 0), other=0.0)
    ns += plgpu.load(hhi_ref.at[0, yc, zc], mask=inb & (i == X - 1),
                     other=0.0)
    prev = inject(plgpu.load(prev_ref.at[i, yc, zc], mask=inb, other=0.0),
                  i, yc, zc, v_prev)

    gx = g[0] + i
    gy = g[1] + yc
    gz = g[2] + zc
    inside = ((gx >= g[3]) & (gx <= g[4]) & (gy >= g[5]) & (gy <= g[6])
              & (gz >= g[7]) & (gz <= g[8]))
    res = jnp.where(inside, COURANT_SQ * ns - prev, 0.0)
    zrow = zc + 0 * yc
    yrow = yc + 0 * zc
    res = jnp.where(gy == g[5] - 1,
                    plgpu.load(pylo_ref.at[i, zrow], mask=inb, other=0.0),
                    res)
    res = jnp.where(gy == g[6] + 1,
                    plgpu.load(pyhi_ref.at[i, zrow], mask=inb, other=0.0),
                    res)
    res = jnp.where(gz == g[7] - 1,
                    plgpu.load(pzlo_ref.at[i, yrow], mask=inb, other=0.0),
                    res)
    res = jnp.where(gz == g[8] + 1,
                    plgpu.load(pzhi_ref.at[i, yrow], mask=inb, other=0.0),
                    res)
    res = jnp.where(gx == g[3] - 1,
                    plgpu.load(pxlo_ref.at[yc, zc], mask=inb, other=0.0),
                    res)
    res = jnp.where(gx == g[4] + 1,
                    plgpu.load(pxhi_ref.at[yc, zc], mask=inb, other=0.0),
                    res)
    plgpu.store(out_ref.at[i, yc, zc], res.astype(out_ref.dtype), mask=inb)


def fused_field(geom, cur, prev, planes, inj_idx, inj_val, halos,
                interpret: bool = False):
    """The next field of ``box_fused._jnp_forward`` (without the inner
    planes).  ``interpret`` runs the kernel on the CPU, for tests."""
    X, Y, Z = cur.shape
    ZP = pl.next_power_of_2(Z)
    kernel = functools.partial(_kernel, X=X, Y=Y, Z=Z, ZP=ZP)
    args = (jnp.asarray(geom, jnp.int32), jnp.asarray(inj_idx, jnp.int32),
            jnp.asarray(inj_val, cur.dtype), cur, prev, halos[0], halos[1],
            *planes)
    return pl.pallas_call(
        kernel,
        grid=(X, pl.cdiv(Y, TILE_Y)),
        out_shape=jax.ShapeDtypeStruct(cur.shape, cur.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="box_fused_step",
    )(*args)
