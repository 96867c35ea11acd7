"""The frozen plain reference against the port's CPU path (the kernels'
plain versions), at a tiny size on the benchmark's seeded weights."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_config

from portbench import harness, program

CONFIGS = ("hyena-125m", "hyenadna-1m")


def _pair(name, dtype):
    cfg = tiny_config(harness.config(name), dtype)
    ref = harness.reference(cfg)
    model = program.build_model(cfg, torch.device("cpu"))
    weights = ref.init_params(cfg, 2**31 + 5, "cpu")
    program.load_weights(model, weights)
    ids = torch.randint(0, cfg["vocab_size"], (2, 128), generator=torch.Generator().manual_seed(3))
    return cfg, ref, model, weights, ids


@pytest.mark.parametrize("name", CONFIGS)
def test_logits_and_grads_match_in_float32(name):
    cfg, ref, model, weights, ids = _pair(name, "float32")
    logits = model(ids)
    want = ref.logits(weights, cfg, ids)
    assert logits.shape == want.shape
    assert (logits - want).abs().max() <= 1e-4 * want.abs().max()
    loss = ref.token_nll(logits, ids.roll(-1, 1)).mean()
    loss.backward()
    leaves = {n: p.detach().clone().requires_grad_() for n, p in weights.items()}
    ref.token_nll(ref.logits(leaves, cfg, ids), ids.roll(-1, 1)).mean().backward()
    for n, p in model.named_parameters():
        g, r = p.grad, leaves[n].grad
        assert (g - r).abs().max() <= 1e-3 * r.abs().max() + 1e-7, n


@pytest.mark.parametrize("name", CONFIGS)
def test_bfloat16_program_is_near_the_float32_reference(name):
    cfg, ref, model, weights, ids = _pair(name, "bfloat16")
    with torch.no_grad():
        gap = float((torch.log_softmax(model(ids).float(), -1)
                     - torch.log_softmax(ref.logits(weights, cfg, ids), -1)).abs().max())
    assert gap < 0.1


def test_weights_repeat_by_seed_and_differ_between_seeds():
    cfg = tiny_config(harness.config("hyena-125m"), "float32")
    ref = harness.reference(cfg)
    a, b = ref.init_params(cfg, 7, "cpu"), ref.init_params(cfg, 7, "cpu")
    c = ref.init_params(cfg, 8, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embeddings.weight"], c["embeddings.weight"])


def test_reference_train_step_follows_torch_adamw():
    """Three of the reference's steps against torch.optim.AdamW with the same
    clip and learning rates, on the reference's own gradients."""
    cfg = tiny_config(harness.config("hyena-125m"), "float32")
    ref = harness.reference(cfg)
    recipe = harness.workload("hyena-125m.train")["params"]["recipe"]
    w0 = ref.init_params(cfg, 3, "cpu")
    gen = torch.Generator().manual_seed(4)
    batches = [(torch.randint(0, 61, (2, 64), generator=gen),) * 2 for _ in range(3)]
    batches = [(x, x.roll(-1, 1)) for x, _ in batches]
    out = ref.train_steps(w0, cfg, recipe, batches)
    params = {n: p.clone().requires_grad_() for n, p in w0.items()}
    opt = torch.optim.AdamW(params.values(), lr=recipe["lr"], betas=recipe["betas"],
                            eps=recipe["eps"], weight_decay=recipe["weight_decay"])
    for t, (x, y) in enumerate(batches):
        for g in opt.param_groups:
            g["lr"] = ref.lr_at(recipe, t)
        opt.zero_grad()
        loss = ref.token_nll(ref.logits(params, cfg, x), y).mean()
        loss.backward()
        assert torch.isclose(loss.detach(), out["losses"][t], rtol=1e-5)
        torch.nn.utils.clip_grad_norm_(params.values(), recipe["clip"])
        opt.step()
    for n, p in params.items():
        assert torch.isclose(torch.linalg.vector_norm(p.detach() - w0[n]),
                             out["change_norms"][n], rtol=1e-4, atol=1e-9), n


def test_lr_schedule_matches_the_port():
    from flashfftconv_tpu_torch.utils.optim import warmup_cosine_decay_schedule

    recipe = harness.workload("hyena-125m.train")["params"]["recipe"]
    ref = harness.reference(harness.config("hyena-125m"))
    sched = warmup_cosine_decay_schedule(0.0, recipe["lr"], 2, recipe["steps"])
    for t in (0, 1, 2, 3, 500, 9999, 20000):
        assert abs(ref.lr_at(recipe, t) - sched(t)) <= 1e-12
