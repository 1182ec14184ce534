"""The port's training slice against the JAX package, on the CPU.

The JAX model runs with ``use_fused=False`` (its plain attention and
autodiff) to keep the cost down; the port's model runs its fused op
unless a test asks for its plain attention or the softmax baseline,
whose CPU path is the plain version of the forward and backward kernels
(``tests/test_torch_backward.py`` holds those against the JAX kernels).
Both take the same numpy-seeded tokens and the same flax parameters.

Bars: the loss to 1e-5; each gradient leaf to 1e-4 of its largest
|entry| (both sides sum in f32, in other orders); parameters after one
optimizer step to 1e-6 (Adam's first step moves each entry by ~lr = 2e-4
whatever its gradient, so a wrong clip, mean or moment shows at once),
except entries whose nonzero gradient is under the gradients' own bar
(at most 1 % of a leaf); an entry whose gradient is exactly zero stays put;
the init's per-leaf standard deviation to 5 % of flax's at width 256
(the sampling error of a 256 x 256 leaf is ~0.3 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_cosine_sim_attention_tpu.data import TextSampler as JaxSampler
from flash_cosine_sim_attention_tpu.models import (
    CosineSimCausalTransformer as JaxModel,
)
from flash_cosine_sim_attention_tpu.models import generate as jax_generate
from flash_cosine_sim_attention_tpu_torch.data import TextSampler
from flash_cosine_sim_attention_tpu_torch.models import (
    CosineSimCausalTransformer,
    generate,
    params_from_flax,
    params_to_flax,
)
from flash_cosine_sim_attention_tpu_torch.train import (
    make_optimizer,
    make_sampler,
    train_step,
)
from flash_cosine_sim_attention_tpu_torch.utils import (
    restore_checkpoint,
    save_checkpoint,
)

MODEL = dict(num_tokens=256, dim=64, depth=2, max_seq_len=64, heads=2,
             dim_head=32, attn_scale=1.0, attn_l2norm_groups=8)


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val, np.float32)


def _models(pre_norm, seed=0, **over):
    cfg = dict(MODEL, **over)
    jcfg = dict(cfg, use_fused=False)
    jmodel = JaxModel(**jcfg, pre_norm=pre_norm, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    tmodel = CosineSimCausalTransformer(**cfg, pre_norm=pre_norm,
                                        device="cpu")
    params_from_flax(params, tmodel)
    return jmodel, params, tmodel


@pytest.mark.parametrize("variant", ["pre-norm", "post-norm",
                                     "plain-attention", "non-cosine",
                                     "heads-512"])
def test_loss_and_grads_match_jax(variant):
    """The port's fused op (pre- and post-norm; and with 1 head of 512, the
    heads-512 model's width, whose float32 attention takes the wide
    route), its plain attention (``use_fused=False``) and the
    vanilla-softmax baseline."""
    over = {"plain-attention": dict(use_fused=False),
            "non-cosine": dict(non_cosine_sim_attn=True),
            "heads-512": dict(heads=1, dim_head=512)}.get(variant, {})
    jmodel, params, tmodel = _models(variant != "post-norm", **over)
    tokens = np.random.default_rng(20).integers(0, 256, (2, 65))
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jmodel.apply(p, jnp.asarray(tokens), return_loss=True)
    )(params)
    loss_t = tmodel(torch.from_numpy(tokens), return_loss=True)
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5
    got = dict(_leaves(params_to_flax(tmodel, grads=True)))
    want = dict(_leaves(jax.tree.map(np.asarray, grads_j)["params"]))
    assert set(got) == set(want)
    for path, g in want.items():
        err = np.abs(got[path] - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (path, err)


def test_train_step_matches_optax():
    """One step over 4 microbatches: mean loss and gradients, global-norm
    clip at 0.5, Adam 2e-4, as train.py builds it from optax."""
    jmodel, params, tmodel = _models(pre_norm=True)
    batches = np.random.default_rng(21).integers(0, 256, (4, 2, 65))
    losses, grads = zip(*(jax.value_and_grad(
        lambda p, b=b: jmodel.apply(p, jnp.asarray(b), return_loss=True)
    )(params) for b in batches))
    grads = jax.tree.map(lambda *g: jnp.stack(g).mean(0), *grads)
    assert float(optax.global_norm(grads)) > 0.5  # the clip is exercised
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(2e-4))
    updates, _ = tx.update(grads, tx.init(params), params)
    want = dict(_leaves(optax.apply_updates(params, updates)["params"]))
    g_leaves = dict(_leaves(jax.tree.map(np.asarray, grads)["params"]))
    before = {k: v.copy() for k, v in _leaves(params["params"])}

    loss = train_step(tmodel, make_optimizer(tmodel),
                      torch.from_numpy(batches))
    assert abs(loss.item() - float(np.mean(losses))) <= 1e-5
    got = dict(_leaves(params_to_flax(tmodel)))
    for path, p in want.items():
        err = np.abs(got[path] - p)
        # an entry whose gradient is under the bar the gradients are held
        # to (1e-4 of the leaf's largest) has no defined Adam direction:
        # its first step lr * g / (|g| + eps) turns on g's last digits.
        # It is held to the most a step can move it.  An entry with an
        # exactly zero gradient (a token not in the batch) must not move.
        g = np.abs(g_leaves[path])
        floor = (g > 0) & (g < 1e-4 * g.max())
        assert err[~floor].max(initial=0) <= 1e-6, (path, err.max())
        assert err[floor].max(initial=0) <= 2 * 2e-4, path
        assert floor.mean() <= 0.01, (path, floor.mean())
        assert np.array_equal(got[path][g == 0], before[path][g == 0]), path


@pytest.mark.parametrize("pre_norm", [True, False])
def test_init_matches_flax_statistics(pre_norm):
    cfg = dict(dim=256, max_seq_len=256, heads=4, dim_head=64)
    _, params, _ = _models(pre_norm, seed=1, **cfg)
    torch.manual_seed(1)
    fresh = CosineSimCausalTransformer(**dict(MODEL, **cfg),
                                       pre_norm=pre_norm, device="cpu")
    got = dict(_leaves(params_to_flax(fresh)))
    for path, p in _leaves(params["params"]):
        if p.std() == 0:              # LayerNorm scale 1 / bias 0
            assert np.array_equal(got[path], p), path
        else:
            assert abs(got[path].std() / p.std() - 1) <= 0.05, path


def test_greedy_generate_matches_jax():
    """filter_thres 0.999 keeps k = 1 of 256 tokens: greedy decoding,
    token for token, past the max_seq_len window."""
    jmodel, params, tmodel = _models(pre_norm=True, max_seq_len=32)
    start = np.random.default_rng(22).integers(0, 256, (2, 8))
    want = jax_generate(jmodel, params, jax.random.PRNGKey(0),
                        jnp.asarray(start), 30, filter_thres=0.999)
    got = generate(tmodel, torch.from_numpy(start), 30, filter_thres=0.999)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_text_sampler_matches_jax_loader(tmp_path):
    data = np.random.default_rng(23).integers(0, 256, 5000).astype(np.uint8)
    jax_s, port_s = JaxSampler(data, seed=7), TextSampler(data, seed=7)
    for split in ("train", "valid", "train"):
        assert np.array_equal(port_s.sample(split, 3, 16),
                              jax_s.sample(split, 3, 16))
    js, ps = jax_s.stream("train", 2, 8), port_s.stream("train", 2, 8)
    for _ in range(3):
        assert np.array_equal(next(ps), next(js))
    # a corpus on disk goes to the native sampler built from
    # native/dataloader.cc: its crops are windows of the corpus
    path = tmp_path / "corpus.raw"
    path.write_bytes(data.tobytes())
    sampler = make_sampler(str(path), seed=3)
    crops = sampler.sample("train", 4, 31)
    assert crops.shape == (4, 32) and crops.dtype == np.int32
    text = data.tobytes()
    assert all(bytes(c.astype(np.uint8)) in text for c in crops)


def test_checkpoint_round_trip_resumes_step_params_and_moments(tmp_path):
    cfg = dict(MODEL, dim=32, depth=1, max_seq_len=16, dim_head=16)
    batches = torch.from_numpy(
        np.random.default_rng(24).integers(0, 256, (4, 2, 17)))
    torch.manual_seed(0)
    model = CosineSimCausalTransformer(**cfg, pre_norm=True, device="cpu")
    opt = make_optimizer(model)
    for step in range(5):
        train_step(model, opt, batches)
        save_checkpoint(str(tmp_path), step, model, opt)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]

    torch.manual_seed(1)
    model2 = CosineSimCausalTransformer(**cfg, pre_norm=True, device="cpu")
    opt2 = make_optimizer(model2)
    assert restore_checkpoint(str(tmp_path / "none"), model2, opt2) is None
    assert restore_checkpoint(str(tmp_path), model2, opt2) == 4
    for p, p2 in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, p2)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt2.state[p2][key])
    train_step(model, opt, batches)
    train_step(model2, opt2, batches)
    assert all(torch.equal(p, p2) for p, p2 in
               zip(model.parameters(), model2.parameters()))
