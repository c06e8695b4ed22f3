"""Adam with per-element non-finite guards, matching the reference optimizer.

The reference implements Adam as three CUDA kernels driven over a flat
registry of 160 param tensors (updateMeans/updateVars/updateParams,
resnet.cu:605-662; update_parameters, resnet.cu:2910-2987). Semantics:

  g'  = g + wd * theta                  (weight decay folded into grad)
  m   = b1 * m + (1 - b1) * g'          (element SKIPPED if g non-finite)
  v   = b2 * v + (1 - b2) * g'^2        (element SKIPPED if g non-finite)
  m^  = m / (1 - b1^t) ; v^ = v / (1 - b2^t)
  theta <- theta - (lr * m^ / (sqrt(v^) + eps) + wd * theta)
                                        (element ROLLED BACK if non-finite)

Note the reference applies weight decay twice: folded into the moment
estimates AND decoupled in the step. We reproduce that exactly (it is the
training dynamic the reference actually ran). The bias-correction products
b1^t, b2^t are carried in the state, updated per step, exactly like
trainer->cur_mean_decay/cur_var_decay (resnet.cu:2920-2921, 2985-2986) —
so they checkpoint/restore the same way (overwrite_trainer_hyperparams,
resnet.cu:2796-2813).

Instead of the reference's flat locations[]/sizes[] registry, state is a
pytree mirroring the params (SURVEY.md section 7: same role, idiomatic).
The whole update is one fused XLA program over the pytree rather than
3 x 160 kernel launches.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class GuardedAdamState(NamedTuple):
    means: Any  # first-moment pytree (prev_means, resnet.h:171)
    vars: Any  # second-moment pytree (prev_vars, resnet.h:172)
    mean_decay_prod: jax.Array  # b1^t running product (cur_mean_decay)
    var_decay_prod: jax.Array  # b2^t running product (cur_var_decay)
    step: jax.Array


def adam_init(params) -> GuardedAdamState:
    zeros = jax.tree.map(lambda p: jnp.zeros_like(p, dtype=jnp.float32), params)
    return GuardedAdamState(
        means=zeros,
        vars=jax.tree.map(jnp.copy, zeros),
        mean_decay_prod=jnp.ones((), jnp.float32),
        var_decay_prod=jnp.ones((), jnp.float32),
        step=jnp.zeros((), jnp.int32),
    )


def adam_update(
    grads,
    state: GuardedAdamState,
    params,
    *,
    learning_rate,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-7,
    nonfinite_guard: bool = True,
    wd_mask=None,
):
    """One Adam step. Returns (new_params, new_state).

    learning_rate may be a python float or a traced scalar (schedules).
    wd_mask: optional pytree of per-leaf 0/1 multipliers on weight decay
    (e.g. exempting BN gamma/beta per the Goyal et al. recipe).
    """
    b1 = jnp.float32(beta1)
    b2 = jnp.float32(beta2)
    wd = jnp.float32(weight_decay)
    lr = jnp.asarray(learning_rate, jnp.float32)
    # advance decay products first, as update_parameters does
    # (resnet.cu:2920-2921): step t uses b1^t with t starting at 1.
    cur_mean_decay = state.mean_decay_prod * b1
    cur_var_decay = state.var_decay_prod * b2

    def leaf_update(p, g, m, v, wleaf):
        pf = p.astype(jnp.float32)
        gf = g.astype(jnp.float32)
        g_wd = gf + wd * wleaf * pf
        new_m = b1 * m + (1 - b1) * g_wd
        new_v = b2 * v + (1 - b2) * jnp.square(g_wd)
        if nonfinite_guard:
            finite = jnp.isfinite(gf)
            new_m = jnp.where(finite, new_m, m)  # resnet.cu:610-616
            new_v = jnp.where(finite, new_v, v)  # resnet.cu:629-636
        m_adj = new_m / (1 - cur_mean_decay)
        v_adj = new_v / (1 - cur_var_decay)
        new_p = pf - (lr * m_adj / (jnp.sqrt(v_adj) + eps) + wd * wleaf * pf)
        if nonfinite_guard:
            # rollback any element that went non-finite (resnet.cu:651-661)
            new_p = jnp.where(jnp.isfinite(new_p), new_p, pf)
        return new_p.astype(p.dtype), new_m, new_v

    flat_p, treedef = jax.tree.flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_m = treedef.flatten_up_to(state.means)
    flat_v = treedef.flatten_up_to(state.vars)
    flat_w = (
        treedef.flatten_up_to(wd_mask)
        if wd_mask is not None
        else [jnp.float32(1.0)] * len(flat_p)
    )
    out = [
        leaf_update(p, g, m, v, wl)
        for p, g, m, v, wl in zip(flat_p, flat_g, flat_m, flat_v, flat_w)
    ]
    new_params = treedef.unflatten([o[0] for o in out])
    new_means = treedef.unflatten([o[1] for o in out])
    new_vars = treedef.unflatten([o[2] for o in out])
    return new_params, GuardedAdamState(
        means=new_means,
        vars=new_vars,
        mean_decay_prod=cur_mean_decay,
        var_decay_prod=cur_var_decay,
        step=state.step + 1,
    )


def guarded_adam(
    learning_rate,
    *,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-7,
    nonfinite_guard: bool = True,
):
    """optax.GradientTransformation-compatible wrapper (init_fn, update_fn).

    update_fn returns *updates* (deltas to add to params), so it composes
    with optax.apply_updates; params are required (weight decay + guards).
    """
    import optax

    def init_fn(params):
        return adam_init(params)

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("guarded_adam requires params")
        lr = learning_rate(state.step) if callable(learning_rate) else learning_rate
        new_params, new_state = adam_update(
            grads,
            state,
            params,
            learning_rate=lr,
            weight_decay=weight_decay,
            beta1=beta1,
            beta2=beta2,
            eps=eps,
            nonfinite_guard=nonfinite_guard,
        )
        updates = jax.tree.map(lambda n, p: n - p, new_params, params)
        return updates, new_state

    return optax.GradientTransformation(init_fn, update_fn)
