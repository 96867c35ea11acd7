"""Parity of the port's ``MoEMlp`` and of its LM with the flax modules.

The flax modules are initialised from a JAX key, their parameters carried
to the port by ``utils.jax_weights``, inputs made with numpy from a seed;
both run in f32 on the CPU. Tolerances: outputs at atol 1e-4, the aux loss
at 1e-6 relative, grads at 1e-4 of each parameter's largest |grad| (the
port's index gather and add against the JAX one-hot einsums: the same
products, summed in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flashfftconv_tpu.models.lm import ConvLMHeadModel as JLM
from flashfftconv_tpu.models.moe import MoEMlp as JMoE
from flashfftconv_tpu_torch.models.lm import Block, ConvLMHeadModel
from flashfftconv_tpu_torch.models.moe import MoEMlp, route
from flashfftconv_tpu_torch.utils import jax_weights

D, F, E = 32, 48, 4


def _np(x):
    return np.array(x, np.float32)


def _grads_close(got: dict, ref: dict, rel=1e-4):
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name].detach().numpy()
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=rel * max(float(np.abs(r).max()), 1e-12),
                                   err_msg=name)


def _pair(top_k, capacity_factor, seed, zero_gate=False):
    x = np.random.default_rng(seed).standard_normal((2, 16, D)).astype(np.float32)
    jm = JMoE(d_model=D, d_inner=F, n_experts=E, top_k=top_k, capacity_factor=capacity_factor)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    if zero_gate:  # every gate probability 1/E: argmax ties everywhere
        params = {**params, "gate": jax.tree_util.tree_map(jnp.zeros_like, params["gate"])}
    pnp = jax.tree_util.tree_map(np.asarray, params)
    tm = MoEMlp(D, F, E, top_k=top_k, capacity_factor=capacity_factor, device="cpu")
    tm.load_state_dict(jax_weights.moe_state_dict(pnp), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("zero_gate", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_flax(top_k, capacity_factor, zero_gate):
    """Output, aux loss, and the grads of every parameter and of x, at an
    ample and a tight capacity; with a zeroed gate every choice is a tie
    (first index wins) and the drops follow token order."""
    jm, params, tm, x = _pair(top_k, capacity_factor, 3 + top_k, zero_gate)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    y, inter = jm.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    aux = float(jax.tree_util.tree_leaves(inter["intermediates"])[0])

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * w)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tm(xt)
    (yt * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), _np(y), atol=1e-4)
    np.testing.assert_allclose(float(tm.aux_loss.detach()), aux, rtol=1e-6)
    ref = {k: v.numpy() for k, v in jax_weights.moe_state_dict(
        jax.tree_util.tree_map(np.asarray, gp)).items()}
    _grads_close({n: p.grad for n, p in tm.named_parameters()}, ref)
    _grads_close({"x": xt.grad}, {"x": _np(gx)})
    kept = float(tm.kept_fraction.sum()) / top_k
    if capacity_factor < 1:
        assert kept <= capacity_factor * 1.01
    elif not zero_gate:
        assert kept > 0.5


def test_route_fill_carries_across_choices():
    """Choice 2 of a token lands after every choice-1 slot of its expert;
    slots past the capacity drop, first index on ties."""
    probs = torch.tensor([[0.5, 0.5, 0.0], [0.6, 0.3, 0.1], [0.2, 0.7, 0.1],
                          [0.4, 0.4, 0.2]])
    slots, weights, fill = route(probs, top_k=2, capacity=2)
    # choice 1: experts 0, 0, 1, 0 -> slots 0, 1, 2 + 0, dropped (expert 0 full)
    # choice 2: experts 1, 1, 0, 1 -> expert 1 has 1 filled: slot 2 + 1, dropped,
    # dropped (expert 0 full), dropped
    assert slots.tolist() == [[0, 1, 2, 6], [3, 6, 6, 6]]
    torch.testing.assert_close(weights, torch.tensor([[0.5, 0.6, 0.7, 0.0],
                                                      [0.5, 0.0, 0.0, 0.0]]))
    assert fill.tolist() == [2, 2, 0]


class _Largest(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_moe_builds_no_tokens_by_experts_by_capacity_tensor():
    """Forward and backward at T = 512, E = 8, top-2: no tensor the size of
    the JAX formulation's (T, E, C) one-hot (81,920 x 8 here)."""
    t, e, k = 512, 8, 2
    tm = MoEMlp(D, F, e, top_k=k, device="cpu", generator=torch.Generator().manual_seed(0))
    cap = tm.capacity(t)
    assert cap == math.ceil(t * k / e * 1.25)
    x = torch.randn(2, t // 2, D, requires_grad=True)
    with _Largest() as mode:
        tm(x).square().sum().backward()
    assert mode.numel < t * e * cap // 8, mode.numel


def _lm_pair(mixer, moe_kwargs, l_max=64):
    jmk = {"impl": "xla", "conv_dtype": jnp.float32} if mixer == "hyena" else {"num_heads": 4}
    jm = JLM(d_model=D, n_layer=2, d_inner=F, vocab_size=40, l_max=l_max, mixer=mixer,
             mixer_kwargs=jmk, moe_kwargs=moe_kwargs, embed_dropout=0.0, dtype=jnp.float32)
    ids = np.random.default_rng(5).integers(0, 40, (2, l_max + 1))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids[:, :-1]))["params"]
    tmk = {"conv_dtype": torch.float32} if mixer == "hyena" else {"num_heads": 4}
    tm = ConvLMHeadModel(D, 2, F, 40, l_max, mixer=mixer, mixer_kwargs=tmk,
                         moe_kwargs=moe_kwargs, embed_dropout=0.0, dtype=torch.float32,
                         device="cpu")
    tm.load_state_dict(jax_weights.from_jax_params(jax.tree_util.tree_map(np.asarray, params)),
                       strict=True)
    return jm, params, tm.eval(), ids


def test_conv_lm_with_moe_matches_flax():
    """A 2-layer Hyena LM with MoE MLPs (4 experts, top-2): logits and the
    grads of a next-token loss, every parameter."""
    jm, params, tm, ids = _lm_pair("hyena", {"n_experts": E, "top_k": 2})
    x, y = ids[:, :-1], ids[:, 1:]

    def loss(p):
        lg = jm.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(lg, -1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[..., None], -1).mean()

    ref_logits = _np(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    logits = tm(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=1e-4)
    lt = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                           torch.from_numpy(y).reshape(-1))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(jl), rtol=1e-5)
    ref = {k: v.numpy() for k, v in jax_weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jg)).items()}
    _grads_close({n: p.grad for n, p in tm.named_parameters()}, ref)


def test_block_step_with_moe_matches_forward():
    """Block.step through an MHA mixer and an MoE MLP (capacity ample at one
    token a step, so no token drops): each step's output equals the full
    forward's at its position."""
    g = torch.Generator().manual_seed(2)
    blk = Block(D, F, mixer="mha", mixer_kwargs={"num_heads": 4},
                moe_kwargs={"n_experts": E, "top_k": 2, "capacity_factor": 8.0}, device="cpu",
                generator=g).eval()
    x = torch.randn(2, 12, D, generator=g)
    with torch.no_grad():
        full = blk(x)
        cache = blk.mixer.init_cache(2, 12)
        steps = []
        for pos in range(12):
            y, cache = blk.step(x[:, pos : pos + 1], cache, pos)
            steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=1e-5)
