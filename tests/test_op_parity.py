"""Op-level parity of the XLA path against the numpy transliteration of the
reference (analysis/reference_numpy.py) — the analogue of the reference's
in-binary GPU-vs-CPU harness (testMatMul resnet.cu:3033, testConvolution
resnet.cu:3109). Forward values and gradients of the FC layer, the
convolutions, BN+ReLU, the residual join, and the guarded Adam update, at
the shapes ResNet uses (scaled down)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from resnet_tpu.analysis.reference_numpy import (
    adam_ref,
    bn_grad_ref,
    bn_ref,
    conv_grad_ref,
    conv_ref,
)
from resnet_tpu.ops import bn_act, conv2d, linear, residual_join
from resnet_tpu.optim import adam_update
from resnet_tpu.optim.adam import GuardedAdamState


class TestLinear:
    @pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128),
                                       (100, 130, 70), (8, 1000, 2048)])
    def test_forward(self, rng, shape):
        m, n, k = shape
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = rng.normal(size=(k, n)).astype(np.float32)
        got = linear(jnp.asarray(a), jnp.asarray(b))
        want = a.astype(np.float64) @ b.astype(np.float64)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)

    def test_grad(self, rng):
        a = rng.normal(size=(64, 96)).astype(np.float32)
        b = rng.normal(size=(96, 32)).astype(np.float32)
        ga, gb = jax.grad(
            lambda a_, b_: jnp.sum(linear(a_, b_) ** 2), argnums=(0, 1)
        )(jnp.asarray(a), jnp.asarray(b))
        dy = 2.0 * (a.astype(np.float64) @ b)
        np.testing.assert_allclose(np.asarray(ga), dy @ b.T, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(np.asarray(gb), a.T @ dy, rtol=1e-4, atol=1e-3)


class TestBnAct:
    @pytest.mark.parametrize("relu", [True, False])
    @pytest.mark.parametrize("shape", [(256, 64), (1000, 130), (64, 8)])
    def test_forward(self, rng, shape, relu):
        m, c = shape
        x = rng.normal(2.0, 3.0, size=(m, 1, 1, c)).astype(np.float32)
        gamma = rng.normal(1.0, 0.1, size=(c,)).astype(np.float32)
        beta = rng.normal(0.0, 0.1, size=(c,)).astype(np.float32)
        y, (mean, var) = bn_act(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), eps=1e-7,
            layout="NHWC", relu=relu,
        )
        y_r, mean_r, var_r = bn_ref(x, gamma, beta, 1e-7, relu=relu)
        np.testing.assert_allclose(np.asarray(mean), mean_r, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(var), var_r, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(y), y_r, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("relu", [True, False])
    def test_backward(self, rng, relu):
        m, c = 512, 96
        x = rng.normal(1.0, 2.0, size=(m, 1, 1, c)).astype(np.float32)
        gamma = rng.normal(1.0, 0.1, size=(c,)).astype(np.float32)
        beta = rng.normal(0.0, 0.1, size=(c,)).astype(np.float32)

        def f(x_, g_, b_):
            y, _ = bn_act(x_, g_, b_, eps=1e-7, layout="NHWC", relu=relu)
            return jnp.sum(y * jnp.cos(y))  # nontrivial downstream

        got = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)
        )
        y = bn_ref(x, gamma, beta, 1e-7, relu=relu)[0].astype(np.float64)
        dy = np.cos(y) - y * np.sin(y)
        want = bn_grad_ref(x, gamma, beta, 1e-7, dy, relu=relu)
        for a, b, name in zip(got, want, ("dx", "dgamma", "dbeta")):
            np.testing.assert_allclose(
                np.asarray(a), b, rtol=1e-3, atol=1e-3, err_msg=name
            )


def test_residual_join_forward_and_grad(rng):
    shape = (4, 7, 7, 130)
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    got = residual_join(jnp.asarray(a), jnp.asarray(b))
    want = np.maximum(a + b, 0)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)

    ga, gb = jax.grad(
        lambda a_, b_: jnp.sum(residual_join(a_, b_) ** 2), argnums=(0, 1)
    )(jnp.asarray(a), jnp.asarray(b))
    # the reference's ReLU gate passes gradient only where a + b > 0
    dwant = 2.0 * want * (a + b > 0)
    np.testing.assert_allclose(np.asarray(ga), dwant, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb), dwant, rtol=1e-5, atol=1e-5)


CONV_CASES = [
    # (h, cin, cout, k, stride) — the shapes ResNet uses, scaled down
    (16, 3, 8, 7, 2),    # stem
    (8, 8, 16, 1, 1),    # 1x1 reduce/expand
    (8, 16, 16, 3, 1),   # 3x3 spatial
    (8, 16, 16, 3, 2),   # 3x3 stride-2 spatial
    (8, 8, 32, 3, 2),    # 3x3/s2 projection (reference quirk)
]


class TestConv:
    @pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES)
    def test_forward(self, rng, h, cin, cout, k, stride):
        x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
        w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
        got = conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride)
        want = conv_ref(x, w, stride)
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES)
    def test_backward(self, rng, h, cin, cout, k, stride):
        x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
        w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
        gx, gw = jax.grad(
            lambda x_, w_: jnp.sum(conv2d(x_, w_, stride=stride) ** 2),
            argnums=(0, 1),
        )(jnp.asarray(x), jnp.asarray(w))
        dy = 2.0 * conv_ref(x, w, stride)
        dx, dw = conv_grad_ref(x, w, dy, stride)
        np.testing.assert_allclose(np.asarray(gw), dw, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(gx), dx, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_adam_update_matches_reference_transcription(rng, weight_decay):
    """Three chained guarded-Adam steps, with NaN/Inf gradient elements,
    against the numpy transcription of the reference's optimizer kernels."""
    n = 1000
    p = rng.normal(size=(n,)).astype(np.float32)
    m = rng.normal(0, 0.01, size=(n,)).astype(np.float32)
    v = np.abs(rng.normal(0, 0.01, size=(n,))).astype(np.float32)
    state = GuardedAdamState(
        means={"w": jnp.asarray(m)}, vars={"w": jnp.asarray(v)},
        mean_decay_prod=jnp.float32(0.9), var_decay_prod=jnp.float32(0.99),
        step=jnp.int32(5),
    )
    params = {"w": jnp.asarray(p)}
    md, vd = 0.9, 0.99
    for step in range(3):
        g = rng.normal(size=(n,)).astype(np.float32)
        g[3 + step] = np.nan
        g[7 + step] = np.inf
        params, state = adam_update(
            {"w": jnp.asarray(g)}, state, params, learning_rate=1e-3,
            weight_decay=weight_decay, beta1=0.9, beta2=0.999, eps=1e-7,
        )
        md, vd = md * 0.9, vd * 0.999
        p, m, v = adam_ref(p, g, m, v, lr=1e-3, wd=weight_decay, b1=0.9,
                           b2=0.999, eps=1e-7, mean_decay=md, var_decay=vd)
    np.testing.assert_allclose(np.asarray(params["w"]), p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(state.means["w"]), m, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(state.vars["w"]), v, rtol=1e-5, atol=1e-7)
    assert float(state.mean_decay_prod) == pytest.approx(md)
    assert int(state.step) == 8


def test_adam_rolls_back_nonfinite_params():
    """A parameter whose update would be non-finite keeps its old value
    (updateParams, resnet.cu:651-661), as the transcription does."""
    p = np.array([1.0, 2.0, 3.0], np.float32)
    g = np.array([1.0, 1.0, 1.0], np.float32)
    m = np.zeros(3, np.float32)
    v = np.array([0.0, -1e30, 0.0], np.float32)  # sqrt(negative) -> NaN
    state = GuardedAdamState(
        means={"w": jnp.asarray(m)}, vars={"w": jnp.asarray(v)},
        mean_decay_prod=jnp.float32(1.0), var_decay_prod=jnp.float32(1.0),
        step=jnp.int32(0),
    )
    got, _ = adam_update({"w": jnp.asarray(g)}, state, {"w": jnp.asarray(p)},
                         learning_rate=1e-3)
    want, _, _ = adam_ref(p, g, m, v, lr=1e-3, wd=0.0, b1=0.9, b2=0.999,
                          eps=1e-7, mean_decay=0.9, var_decay=0.999)
    np.testing.assert_array_equal(np.asarray(got["w"]), want)
    assert np.asarray(got["w"])[1] == 2.0
