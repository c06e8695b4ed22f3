"""Op-level parity tests against independent numpy references — the
analogue of the reference's in-binary GPU-vs-CPU kernel tests
(testConvolution resnet.cu:3109-3218, testMatMul resnet.cu:3033-3107)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from resnet_tpu.ops import (
    batch_norm,
    conv2d,
    cross_entropy,
    global_avg_pool,
    max_pool,
    reference_padding,
    relu,
    softmax,
)


def np_conv2d_reference(x, w, stride):
    """Direct NHWC conv with reference window geometry: out = in // stride,
    window centered at stride*o with offsets -k//2..k//2, OOB taps = 0
    (doConvolution, resnet.cu:109-157)."""
    n, h, wdim, cin = x.shape
    kh, kw, _, cout = w.shape
    oh, ow = h // stride, wdim // stride
    out = np.zeros((n, oh, ow, cout), np.float32)
    half_h, half_w = kh // 2, kw // 2
    for oi in range(oh):
        for oj in range(ow):
            ci, cj = stride * oi, stride * oj
            for di in range(-half_h, half_h + 1):
                for dj in range(-half_w, half_w + 1):
                    si, sj = ci + di, cj + dj
                    if si < 0 or si >= h or sj < 0 or sj >= wdim:
                        continue
                    # (n,cin) x (cin,cout)
                    out[:, oi, oj, :] += x[:, si, sj, :] @ w[di + half_h, dj + half_w]
    return out


@pytest.mark.parametrize(
    "h,k,stride", [(8, 3, 1), (8, 3, 2), (8, 1, 1), (8, 1, 2), (14, 7, 2), (8, 7, 1)]
)
def test_conv2d_matches_reference_geometry(rng, h, k, stride):
    x = rng.standard_normal((2, h, h, 3), dtype=np.float32)
    w = rng.standard_normal((k, k, 3, 5), dtype=np.float32)
    got = np.asarray(conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride))
    want = np_conv2d_reference(x, w, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv2d_nchw_matches_nhwc(rng):
    x = rng.standard_normal((2, 8, 8, 3), dtype=np.float32)
    w = rng.standard_normal((3, 3, 3, 4), dtype=np.float32)
    y_nhwc = np.asarray(conv2d(jnp.asarray(x), jnp.asarray(w), stride=2))
    x_nchw = jnp.asarray(x.transpose(0, 3, 1, 2))
    y_nchw = np.asarray(conv2d(x_nchw, jnp.asarray(w), stride=2, layout="NCHW"))
    np.testing.assert_allclose(y_nchw.transpose(0, 2, 3, 1), y_nhwc, rtol=1e-5, atol=1e-5)


def test_reference_padding_values():
    # k=7, s=2, in=224: reference pads (3, 2); XLA SAME would pad (2, 3).
    assert reference_padding(224, 7, 2) == (3, 2)
    # k=3, s=2, in=112 (maxpool): (1, 0)
    assert reference_padding(112, 3, 2) == (1, 0)
    # k=3, s=1: symmetric (1, 1)
    assert reference_padding(56, 3, 1) == (1, 1)
    # k=1, s=2: negative hi pad (crops odd rows/cols)
    assert reference_padding(56, 1, 2) == (0, -1)


def test_batch_norm_matches_numpy(rng):
    x = rng.standard_normal((4, 6, 6, 8), dtype=np.float32)
    gamma = rng.standard_normal(8, dtype=np.float32)
    beta = rng.standard_normal(8, dtype=np.float32)
    eps = 1e-7
    y, (mean, var) = batch_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), eps=eps)
    m = x.mean(axis=(0, 1, 2))
    v = x.var(axis=(0, 1, 2))  # biased, matches doBatchNormAndActivate
    want = gamma * (x - m) / np.sqrt(v + eps) + beta
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(mean), m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(var), v, rtol=1e-4, atol=1e-5)


def test_batch_norm_backward_matches_numerical(rng):
    # Check BN input gradient against central differences — the analogue of
    # validating activationAndBatchNormDeriv (resnet.cu:350-430).
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float64)
    gamma = rng.standard_normal(4)
    beta = rng.standard_normal(4)

    def f(x64):
        y, _ = batch_norm(
            x64, jnp.asarray(gamma), jnp.asarray(beta), eps=1e-7
        )
        return jnp.sum(jnp.sin(y))  # arbitrary downstream

    with jax.enable_x64(True):
        g = jax.grad(f)(jnp.asarray(x))
        eps = 1e-6
        for idx in [(0, 0, 0, 0), (1, 2, 1, 3), (0, 1, 2, 2)]:
            xp = x.copy(); xp[idx] += eps
            xm = x.copy(); xm[idx] -= eps
            num = (float(f(jnp.asarray(xp))) - float(f(jnp.asarray(xm)))) / (2 * eps)
            assert abs(float(g[idx]) - num) < 1e-5


def test_max_pool_matches_numpy(rng):
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    got = np.asarray(max_pool(jnp.asarray(x), kernel=3, stride=2))
    n, h, w, c = x.shape
    want = np.full((n, 4, 4, c), -np.inf, np.float32)
    for oi in range(4):
        for oj in range(4):
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    si, sj = 2 * oi + di, 2 * oj + dj
                    if 0 <= si < h and 0 <= sj < w:
                        want[:, oi, oj] = np.maximum(want[:, oi, oj], x[:, si, sj])
    np.testing.assert_allclose(got, want)


def test_max_pool_grad_scatters_to_argmax(rng):
    # Gradient must flow only to the max element of each window
    # (maxPoolDeriv, resnet.cu:476-497).
    x = rng.standard_normal((1, 4, 4, 1), dtype=np.float32)
    g = jax.grad(lambda t: jnp.sum(max_pool(t, kernel=3, stride=2)))(jnp.asarray(x))
    g = np.asarray(g)
    assert g.sum() == pytest.approx(4.0)  # 4 windows, one unit of grad each
    assert ((g == 0) | (g >= 1)).all()


def test_max_pool_mask_vjp_matches_select_scatter(rng):
    # ops/pooling.py 'mask' VJP (fusible reconstruction of maxPoolDeriv,
    # resnet.cu:476-497) must produce the exact SelectAndScatter gradient.
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 4), dtype=np.float32))
    dy_seed = jnp.asarray(rng.standard_normal((2, 4, 4, 4), dtype=np.float32))

    def grad_of(mode):
        f = lambda t: jnp.sum(max_pool(t, kernel=3, stride=2, vjp=mode) * dy_seed)
        return np.asarray(jax.grad(f)(x))

    # tight-eps, not bitwise: cells covered by several windows accumulate
    # their contributions in a different order in the two realizations
    np.testing.assert_allclose(
        grad_of("select_scatter"), grad_of("mask"), rtol=1e-6, atol=1e-6
    )


def test_max_pool_mask_vjp_tie_breaking_first_win():
    # All-equal input: every window cell ties. Both backends must send each
    # window's whole gradient to the FIRST max in scan order (the
    # reference's strict '>' keeps the first hit, resnet.cu:461).
    x = jnp.ones((1, 6, 6, 2), dtype=jnp.float32)
    g_ss = jax.grad(lambda t: jnp.sum(max_pool(t, vjp="select_scatter")))(x)
    g_mk = jax.grad(lambda t: jnp.sum(max_pool(t, vjp="mask")))(x)
    np.testing.assert_array_equal(np.asarray(g_ss), np.asarray(g_mk))
    # conservation: one unit of grad per window per channel (9 windows x 2
    # channels), nothing duplicated to ties
    assert float(jnp.sum(g_mk)) == pytest.approx(18.0)


def test_max_pool_mask_vjp_nchw(rng):
    x = jnp.asarray(rng.standard_normal((2, 4, 8, 8), dtype=np.float32))
    for mode in ("select_scatter", "mask"):
        y = max_pool(x, kernel=3, stride=2, layout="NCHW", vjp=mode)
        assert y.shape == (2, 4, 4, 4)
    g_ss = jax.grad(lambda t: jnp.sum(
        max_pool(t, layout="NCHW", vjp="select_scatter") ** 2))(x)
    g_mk = jax.grad(lambda t: jnp.sum(
        max_pool(t, layout="NCHW", vjp="mask") ** 2))(x)
    np.testing.assert_array_equal(np.asarray(g_ss), np.asarray(g_mk))


def test_global_avg_pool(rng):
    x = rng.standard_normal((3, 7, 7, 5), dtype=np.float32)
    got = np.asarray(global_avg_pool(jnp.asarray(x)))
    np.testing.assert_allclose(got, x.mean(axis=(1, 2)), rtol=1e-6, atol=1e-6)


def test_relu_grad_gate_strict(rng):
    # reference zeroes gradient at x <= 0 strictly (resnet.cu:558-563)
    x = jnp.asarray([-1.0, 0.0, 2.0])
    g = jax.grad(lambda t: jnp.sum(relu(t)))(x)
    np.testing.assert_array_equal(np.asarray(g), [0.0, 0.0, 1.0])


def test_softmax_naive_matches_reference_formula(rng):
    x = rng.standard_normal((4, 10), dtype=np.float32)
    got = np.asarray(softmax(jnp.asarray(x), stable=False))
    want = np.exp(x) / np.exp(x).sum(axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # stable version agrees on safe inputs
    np.testing.assert_allclose(
        np.asarray(softmax(jnp.asarray(x), stable=True)), want, rtol=1e-5, atol=1e-6
    )


def test_cross_entropy_sum_grad_is_softmax_minus_onehot(rng):
    # The reference's backward seed: grad logits = softmax - onehot, summed
    # over batch, never averaged (resnet.cu:1800-1811).
    logits = jnp.asarray(rng.standard_normal((4, 6), dtype=np.float32))
    labels = jnp.asarray([1, 3, 0, 5])
    g = jax.grad(lambda l: cross_entropy(l, labels, reduction="sum"))(logits)
    p = np.asarray(softmax(logits))
    onehot = np.eye(6, dtype=np.float32)[np.asarray(labels)]
    np.testing.assert_allclose(np.asarray(g), p - onehot, rtol=1e-5, atol=1e-6)


def test_relu_cap_dispatch():
    """Clipped ReLU (cuDNN-fast cap 10, resnet_cudnn_fast.cu:1143-1145)
    through the BN+act and residual-join ops."""
    import jax.numpy as jnp

    from resnet_tpu.ops import bn_act, residual_join

    x = jnp.asarray([[-5.0, 2.0, 50.0, 7.0]], jnp.float32).reshape(1, 1, 1, 4)
    gamma = jnp.ones((4,), jnp.float32)
    beta = jnp.zeros((4,), jnp.float32)
    # eval-mode BN with identity stats (mean 0, var 1) keeps values intact
    y, _ = bn_act(
        x, gamma, beta, eps=0.0, layout="NHWC", relu=True, relu_cap=10.0,
        mean=jnp.zeros((4,)), var=jnp.ones((4,)),
    )
    np.testing.assert_allclose(
        np.asarray(y).ravel(), [0.0, 2.0, 10.0, 7.0], atol=1e-5
    )

    a = jnp.full((1, 1, 1, 4), 8.0, jnp.float32)
    b = jnp.asarray([[-20.0, 0.0, 1.0, 8.0]], jnp.float32).reshape(1, 1, 1, 4)
    j = residual_join(a, b, relu_cap=10.0)
    np.testing.assert_allclose(np.asarray(j).ravel(), [0.0, 8.0, 9.0, 10.0], atol=1e-6)


def test_ghost_bn_custom_vjp_matches_autodiff():
    """batch_norm_ghost's hand-written backward must equal autodiff of the
    sliced-moments formulation (stats over x[:k], normalize all)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from resnet_tpu.ops.batchnorm import (
        batch_moments,
        batch_norm,
        batch_norm_ghost,
    )

    rng = np.random.default_rng(3)
    n, h, w, c = 6, 4, 5, 3
    k = 2
    x = jnp.asarray(rng.normal(0, 2, (n, h, w, c)), jnp.float32)
    gamma = jnp.asarray(rng.normal(1, 0.2, (c,)), jnp.float32)
    beta = jnp.asarray(rng.normal(0, 0.2, (c,)), jnp.float32)
    dy = jnp.asarray(rng.normal(0, 1, (n, h, w, c)), jnp.float32)

    def ref(x, gamma, beta):
        mean, var = batch_moments(x[:k], "NHWC")
        y, _ = batch_norm(x, gamma, beta, mean=mean, var=var, eps=1e-5)
        return jnp.sum(y * dy)

    def ghost(x, gamma, beta):
        y, _ = batch_norm_ghost(x, gamma, beta, k, eps=1e-5)
        return jnp.sum(y * dy)

    # forwards identical
    np.testing.assert_allclose(float(ref(x, gamma, beta)),
                               float(ghost(x, gamma, beta)), rtol=1e-5)
    g_ref = jax.grad(ref, argnums=(0, 1, 2))(x, gamma, beta)
    g_ghost = jax.grad(ghost, argnums=(0, 1, 2))(x, gamma, beta)
    for a, b in zip(g_ref, g_ghost):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)

    # k >= n degenerates to exact full-batch batch_norm
    y_full, _ = batch_norm(x, gamma, beta, eps=1e-5)
    y_g, _ = batch_norm_ghost(x, gamma, beta, n, eps=1e-5)
    np.testing.assert_allclose(np.asarray(y_full), np.asarray(y_g), rtol=1e-6)


def test_ghost_bn_nchw_layout():
    """batch_norm_ghost handles NCHW (batch is dim 0 in both layouts; the
    stats-sample mask and m_k must follow the layout's reduce axes)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from resnet_tpu.ops.batchnorm import batch_moments, batch_norm, batch_norm_ghost

    rng = np.random.default_rng(5)
    n, c, h, w = 6, 3, 4, 5
    k = 3
    x = jnp.asarray(rng.normal(0, 2, (n, c, h, w)), jnp.float32)
    gamma = jnp.asarray(rng.normal(1, 0.2, (c,)), jnp.float32)
    beta = jnp.asarray(rng.normal(0, 0.2, (c,)), jnp.float32)
    dy = jnp.asarray(rng.normal(0, 1, (n, c, h, w)), jnp.float32)

    def ref(x, gamma, beta):
        mean, var = batch_moments(x[:k], "NCHW")
        y, _ = batch_norm(x, gamma, beta, mean=mean, var=var, eps=1e-5,
                          layout="NCHW")
        return jnp.sum(y * dy)

    def ghost(x, gamma, beta):
        y, _ = batch_norm_ghost(x, gamma, beta, k, eps=1e-5, layout="NCHW")
        return jnp.sum(y * dy)

    np.testing.assert_allclose(float(ref(x, gamma, beta)),
                               float(ghost(x, gamma, beta)), rtol=1e-5)
    g_ref = jax.grad(ref, argnums=(0, 1, 2))(x, gamma, beta)
    g_ghost = jax.grad(ghost, argnums=(0, 1, 2))(x, gamma, beta)
    for a, b in zip(g_ref, g_ghost):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


def test_execution_config_validates_axes():
    import pytest

    from resnet_tpu.config import ExecutionConfig

    ExecutionConfig(layout="NCHW", remat="elementwise")  # valid
    with pytest.raises(ValueError, match="layout"):
        ExecutionConfig(layout="NHCW")
    with pytest.raises(TypeError):
        ExecutionConfig(kernels="xla")  # no engine axis: one XLA path
    with pytest.raises(ValueError, match="bn_mode"):
        ExecutionConfig(bn_mode="running")


def test_1x1_stride2_dot_path_matches_lax_conv(rng):
    """The strided-1x1 subsample+dot route (standard-topology projection
    shortcuts) must equal lax.conv with reference geometry — values and
    input gradients, both layouts."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from resnet_tpu.ops.conv import conv2d
    from resnet_tpu.ops.padding import reference_padding

    for layout in ("NHWC", "NCHW"):
        h, ci, co = 8, 8, 16
        shape = (2, h, h, ci) if layout == "NHWC" else (2, ci, h, h)
        x = jnp.asarray(rng.normal(0, 1, shape).astype(np.float32))
        w = jnp.asarray(rng.normal(0, 0.1, (1, 1, ci, co)).astype(np.float32))
        pad = (reference_padding(h, 1, 2), reference_padding(h, 1, 2))
        dn = (layout, "HWIO", layout)

        def ours(x_):
            return conv2d(x_, w, stride=2, layout=layout, precision="highest")

        def ref(x_):
            return lax.conv_general_dilated(
                x_, w, (2, 2), pad, dimension_numbers=dn,
                precision=lax.Precision.HIGHEST,
            )

        np.testing.assert_allclose(
            np.asarray(ours(x)), np.asarray(ref(x)), rtol=1e-6, atol=1e-6
        )
        g1 = jax.grad(lambda x_: ours(x_).sum())(x)
        g2 = jax.grad(lambda x_: ref(x_).sum())(x)
        np.testing.assert_allclose(
            np.asarray(g1), np.asarray(g2), rtol=1e-6, atol=1e-6
        )


def test_s2_phase_backward_matches_autodiff(rng, monkeypatch):
    """Phase-plane stride-2 backward-data (RESNET_TPU_S2_PHASE_BWD,
    round-4 backward experiment b): dx/dw through conv2d with the axis on
    must match plain lax.conv autodiff for every s2 conv shape class the
    models use (3x3 spatial, 1x1 and 3x3 projections, 7x7 stem) plus a
    non-square weighted-cotangent case."""
    import resnet_tpu.ops.conv as C

    cases = [
        (8, 3), (8, 1), (8, 7), (12, 3), (16, 5),
    ]
    for h, k in cases:
        ci, co = 8, 16
        x = jnp.asarray(rng.normal(0, 1, (2, h, h, ci)).astype(np.float32))
        w = jnp.asarray(
            rng.normal(0, 0.1, (k, k, ci, co)).astype(np.float32)
        )
        ct = jnp.asarray(
            rng.normal(0, 1, (2, h // 2, h // 2, co)).astype(np.float32)
        )

        def loss(x_, w_):
            y = C.conv2d(x_, w_, stride=2, layout="NHWC",
                         precision="highest")
            return jnp.vdot(y, ct)

        monkeypatch.setattr(C, "_S2_PHASE_BWD", False)
        y0 = C.conv2d(x, w, stride=2, layout="NHWC", precision="highest")
        gx0, gw0 = jax.grad(loss, argnums=(0, 1))(x, w)
        monkeypatch.setattr(C, "_S2_PHASE_BWD", True)
        y1 = C.conv2d(x, w, stride=2, layout="NHWC", precision="highest")
        gx1, gw1 = jax.grad(loss, argnums=(0, 1))(x, w)
        monkeypatch.setattr(C, "_S2_PHASE_BWD", False)

        np.testing.assert_allclose(np.asarray(y0), np.asarray(y1),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{h},{k}")
        np.testing.assert_allclose(np.asarray(gx0), np.asarray(gx1),
                                   rtol=1e-5, atol=1e-5, err_msg=f"{h},{k}")
        np.testing.assert_allclose(np.asarray(gw0), np.asarray(gw1),
                                   rtol=1e-5, atol=1e-5, err_msg=f"{h},{k}")
