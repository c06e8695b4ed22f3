"""Space-to-depth stem transform (the MLPerf ResNet trick).

The stem conv (7x7/s2 over 3 channels, resnet.cu:3246) is the worst-mapped
op in the network for a matrix unit: only 3 input channels feed each
tap's contraction. Folding 2x2 spatial blocks
into channels reshapes the input (B,224,224,3) -> (B,112,112,12) and turns
the stem into a 4x4/s1 conv over 12 channels — same math, exactly (each
original tap (di,dj) lands at s2d tap (q,p) = ((di+4)//2, (dj+4)//2) and
channel slot (r,s) = ((di+4)%2, (dj+4)%2), with the 7x7 kernel zero-padded
to 8x8 at the leading edge).

Geometry matches the reference's centered windows (pad lo 3 / hi 2 in
original space = lo 2 / hi 1 in s2d space for 224->112).

Enabled by ExecutionConfig(space_to_depth=True); parity-tested against the
standard stem in tests/test_ops.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def space_to_depth(x: jax.Array, block: int = 2) -> jax.Array:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b), channel order (dr, dc, c)."""
    b, h, w, c = x.shape
    assert h % block == 0 and w % block == 0
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


def s2d_stem_weights(w: jax.Array) -> jax.Array:
    """(7,7,3,F) stem weights -> (4,4,12,F) s2d weights.

    Zero-pads the 7x7 kernel to 8x8 at the leading edge (tap di=-4 does not
    exist) and regroups (2q+r, 2p+s, c) -> (q, p, (r,s,c))."""
    kh, kw, cin, f = w.shape
    assert kh == 7 and kw == 7, "s2d stem transform assumes the 7x7 stem"
    wp = jnp.pad(w, ((1, 0), (1, 0), (0, 0), (0, 0)))  # (8,8,cin,f)
    # (q, r, p, s, c, f)
    wr = wp.reshape(4, 2, 4, 2, cin, f)
    # -> (q, p, r, s, c, f) -> (4, 4, 4*cin, f)
    wr = wr.transpose(0, 2, 1, 3, 4, 5)
    return wr.reshape(4, 4, 4 * cin, f)


def s2d_stem_conv(x: jax.Array, w: jax.Array, *, precision) -> jax.Array:
    """Reference stem conv(7x7, s2, pad(3,2)) via s2d: conv(4x4, s1, pad(2,1)).

    x: (B, H, W, 3) original image; w: (7,7,3,F) original weights.
    Returns (B, H/2, W/2, F), bit-equivalent up to fp reassociation."""
    xs = space_to_depth(x, 2)
    ws = s2d_stem_weights(w).astype(x.dtype)
    return lax.conv_general_dilated(
        xs, ws, (1, 1), ((2, 1), (2, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=precision,
    )
