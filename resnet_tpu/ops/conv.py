"""2-D convolution via XLA.

Replaces the reference's direct conv kernels (doConvolution resnet.cu:109,
convolutionDerivInput resnet.cu:166, convolutionDerivWeights resnet.cu:227)
and its cuDNN wrappers (resnet_cudnn_fast.cu:1248-1521). On the GPU, XLA
hands the convolution to cuDNN and autotunes the algorithm, playing the
role of the reference's cudnnFind* machinery
(resnet_cudnn_fast.cu:1275-1303). Backward (data + filter) comes from
autodiff of lax.conv_general_dilated, including the reference's 'toAdd'
gradient accumulation at residual joins (resnet_cudnn.cu:1531-1536), which
autodiff expresses as '+' in the cotangent graph.

Weights are stored HWIO regardless of activation layout; the reference's
per-call NCHW<->NHWC filter transforms (resnet_cudnn.cu:1528,1593) have no
equivalent — XLA handles layout at compile time.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .padding import reference_padding

_DIM_NUMBERS = {
    "NHWC": ("NHWC", "HWIO", "NHWC"),
    "NCHW": ("NCHW", "HWIO", "NCHW"),
}

_PRECISION = {
    "default": lax.Precision.DEFAULT,
    "high": lax.Precision.HIGH,
    "highest": lax.Precision.HIGHEST,
}

# Strided-1x1 subsample+dot route: OFF by default (XLA's strided conv is
# the default path); kept env-gated with a parity test. Not measured on the
# GPU.
import os as _os

_S2_DOT = _os.environ.get("RESNET_TPU_1X1S2_DOT", "0") == "1"


def spatial_dims(layout: str) -> Tuple[int, int]:
    return (1, 2) if layout == "NHWC" else (2, 3)


def channel_dim(layout: str) -> int:
    return 3 if layout == "NHWC" else 1


def conv2d(
    x: jax.Array,
    w: jax.Array,
    *,
    stride: int = 1,
    layout: str = "NHWC",
    padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
    precision: str = "highest",
    groups: int = 1,
) -> jax.Array:
    """Convolution with reference-centered windows by default.

    x: (N,H,W,C) or (N,C,H,W); w: (kh,kw,in/groups,out) HWIO.
    groups > 1 = grouped convolution (ResNeXt).
    """
    kh, kw = w.shape[0], w.shape[1]
    hdim, wdim = spatial_dims(layout)
    if (
        kh == 1 and kw == 1 and padding is None and groups == 1
        and (stride == 1 or _S2_DOT)
    ):
        # 1x1 conv IS a matmul over (N*H*W, Cin) — route it straight to
        # dot (a GEMM). 32 of ResNet-50's 53 convs are 1x1. Stride-2 (the
        # standard-topology projection shortcuts) subsamples first: a 1x1
        # window never overlaps, so conv(x, w, s) == dot(x[::s, ::s], w)
        # exactly (reference_padding is 0 for k=1), and the backward is a
        # dot VJP plus a cheap interior-pad scatter instead of an
        # input-dilated gradient conv.
        if stride > 1:
            if (x.shape[hdim] % stride) or (x.shape[wdim] % stride):
                raise ValueError(
                    "reference conv geometry requires stride | in_dim, got "
                    f"{x.shape[hdim]}x{x.shape[wdim]}/{stride}"
                )
            if layout == "NHWC":
                x = x[:, ::stride, ::stride, :]
            else:
                x = x[:, :, ::stride, ::stride]
        wk = w.reshape(w.shape[2], w.shape[3]).astype(x.dtype)
        if layout == "NHWC":
            n, h, ww, c = x.shape
            y = jnp.dot(
                x.reshape(-1, c), wk, precision=_PRECISION[precision]
            )
            return y.reshape(n, h, ww, -1)
        n, c, h, ww = x.shape
        xh = jnp.moveaxis(x, 1, -1).reshape(-1, c)
        y = jnp.dot(xh, wk, precision=_PRECISION[precision])
        return jnp.moveaxis(y.reshape(n, h, ww, -1), -1, 1)
    if padding is None:
        padding = (
            reference_padding(x.shape[hdim], kh, stride),
            reference_padding(x.shape[wdim], kw, stride),
        )
    if (
        _S2_PHASE_BWD and stride == 2 and groups == 1 and layout == "NHWC"
        and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
    ):
        return _conv_s2_phase(x, w.astype(x.dtype), padding,
                              _PRECISION[precision])
    return lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(stride, stride),
        padding=padding,
        dimension_numbers=_DIM_NUMBERS[layout],
        feature_group_count=groups,
        precision=_PRECISION[precision],
    )


# Phase-plane stride-2 backward-data: XLA expresses dgrad of a strided
# conv as an lhs_dilated (zero-stuffed) convolution; this axis instead
# computes each of the 4 residue planes of dx with a small dense stride-1
# conv over dy and interleaves them with a reshape/transpose. Env-gated
# (off by default), parity-tested; not measured on the GPU.
_S2_PHASE_BWD = _os.environ.get("RESNET_TPU_S2_PHASE_BWD", "0") == "1"


def _phase_bwd_data(dy, w, in_h, in_w, padding, precision):
    """dx of conv2d(x, w, stride=2, padding) via 4 dense s1 convs on dy.

    dx[n, 2ho+a, 2wo+b, ci] = sum_t,u dy[n, ho+t, wo+u] . k_ab[t, u]
    with k_ab the (flipped, phase-gathered) taps w[a+p_lo-2t, b+q_lo-2u];
    negative window padding crops dy where the tap range starts inside.
    """
    kh, kw, ci, co = w.shape
    (p_lo, _p_hi), (q_lo, _q_hi) = padding
    n = dy.shape[0]
    ho2, wo2 = in_h // 2, in_w // 2

    def taps(a, p, k):
        # t-range with 0 <= i = a + p - 2t < k
        t_lo = -((k - 1 - a - p) // 2)  # ceil((a+p-k+1)/2)
        t_hi = (a + p) // 2
        return t_lo, t_hi

    planes = []
    for a in (0, 1):
        th_lo, th_hi = taps(a, p_lo, kh)
        for b in (0, 1):
            tw_lo, tw_hi = taps(b, q_lo, kw)
            if th_hi < th_lo or tw_hi < tw_lo:
                # no tap of the strided window ever lands on this residue
                # (e.g. odd rows under a 1x1/s2 conv): dx plane is zero
                planes.append(
                    jnp.zeros((n, ho2, wo2, ci), dy.dtype)
                )
                continue
            kern = jnp.stack(
                [
                    jnp.stack(
                        [
                            w[a + p_lo - 2 * (th_lo + th),
                              b + q_lo - 2 * (tw_lo + tw)]
                            for tw in range(tw_hi - tw_lo + 1)
                        ],
                        axis=0,
                    )
                    for th in range(th_hi - th_lo + 1)
                ],
                axis=0,
            )  # (Th, Tw, ci, co)
            planes.append(
                lax.conv_general_dilated(
                    dy,
                    jnp.swapaxes(kern, 2, 3),  # contract over co
                    window_strides=(1, 1),
                    padding=((-th_lo, ho2 - 1 + th_hi - (dy.shape[1] - 1)),
                             (-tw_lo, wo2 - 1 + tw_hi - (dy.shape[2] - 1))),
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    precision=precision,
                )
            )
    P = jnp.stack(planes, axis=-1)  # (n, Ho2, Wo2, ci, 4) [a*2+b]
    P = P.reshape(n, ho2, wo2, ci, 2, 2)
    dx = P.transpose(0, 1, 4, 2, 5, 3)
    return dx.reshape(n, in_h, in_w, ci)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _conv_s2_phase(x, w, padding, precision):
    return lax.conv_general_dilated(
        x, w, window_strides=(2, 2), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=precision,
    )


def _conv_s2_phase_fwd(x, w, padding, precision):
    return _conv_s2_phase(x, w, padding, precision), (x, w)


def _conv_s2_phase_bwd(padding, precision, res, dy):
    x, w = res
    dx = _phase_bwd_data(dy, w, x.shape[1], x.shape[2], padding, precision)
    _, wgrad = jax.vjp(
        lambda w_: lax.conv_general_dilated(
            x, w_, window_strides=(2, 2), padding=padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=precision,
        ),
        w,
    )
    (dw,) = wgrad(dy)
    return dx.astype(x.dtype), dw


_conv_s2_phase.defvjp(_conv_s2_phase_fwd, _conv_s2_phase_bwd)
