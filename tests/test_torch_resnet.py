"""The port's ResNet, loss and optimizer against the JAX package.

JAX ``init_cnn`` parameters pass through ``repro_torch.convert``; logits and
one SGD step are compared on the same numpy-seeded images.

Tolerances: rtol 1e-4 relative to the largest value (f32 on both sides; the
convolutions and GroupNorm reductions sum in a different order), and the
cross-entropy at rtol 1e-6 (one logsumexp per row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resnet50_cl as jcfgs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import model_zoo as jzoo
from repro.models import resnet as jresnet
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.configs import resnet50_cl as tcfgs
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import cnn_params_from_jax, named_from_tree, opt_state_from_jax
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import resnet as tresnet
from repro_torch.optim import make_optimizer

# (name, JAX config, port config, image size) -- reduced() and narrow
# bottleneck stacks whose second stage starts with a stride-2 block, on even
# (pads (0, 1)) and odd (pads (1, 1)) inputs; ghost blocks on both
CONFIGS = {
    "reduced": (jcfgs.reduced(num_classes=12), tcfgs.reduced(num_classes=12), 32),
    "bottleneck_even": (
        jcfgs.CNNConfig("b", "resnet50", num_classes=10, width=4, stage_blocks=(1, 2)),
        tcfgs.CNNConfig("b", "resnet50", num_classes=10, width=4, stage_blocks=(1, 2)),
        16),
    "bottleneck_odd": (
        jcfgs.CNNConfig("b", "resnet50", num_classes=10, width=4, stage_blocks=(2, 1)),
        tcfgs.CNNConfig("b", "resnet50", num_classes=10, width=4, stage_blocks=(2, 1)),
        15),
    # ghost blocks: an identity block, then a stride-2 projection block
    "ghost_even": (
        jcfgs.CNNConfig("g", "ghostnet", num_classes=10, width=4, stage_blocks=(1, 2)),
        tcfgs.CNNConfig("g", "ghostnet", num_classes=10, width=4, stage_blocks=(1, 2)),
        16),
    "ghost_odd": (
        jcfgs.CNNConfig("g", "ghostnet", num_classes=10, width=4, stage_blocks=(1, 2)),
        tcfgs.CNNConfig("g", "ghostnet", num_classes=10, width=4, stage_blocks=(1, 2)),
        15),
}


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + 1e-7, (err, np.abs(want).max())


def _setup(name, batch=3, seed=0):
    jcfg, tcfg, size = CONFIGS[name]
    params = jax.jit(lambda k: jresnet.init_cnn(k, jcfg))(jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, batch).astype(np.int32)
    return jcfg, tcfg, params, cnn_params_from_jax(np_params, tcfg, "cpu"), images, labels


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_jax(name):
    jcfg, tcfg, params, model, images, _ = _setup(name)
    want = jax.jit(lambda p, x: jresnet.cnn_outputs(p, x, jcfg))(
        params, jnp.asarray(images))
    with torch.no_grad():
        out = tresnet.cnn_outputs(model, torch.from_numpy(images))
    _close(out["logits"].numpy(), want["logits"])
    _close(out["embed"].numpy(), want["embed"])


@pytest.mark.parametrize("name", ["reduced", "bottleneck_even", "ghost_even", "ghost_odd"])
def test_one_sgd_step_matches_jax(name):
    jcfg, tcfg, params, model, images, labels = _setup(name, batch=4, seed=1)
    labels[1] = -1  # a masked row, as an invalid representative carries
    recipe = dict(peak_lr=0.1, warmup_steps=1, grad_clip=1.0)

    def jloss(p):
        logits = jresnet.apply_cnn(p, jnp.asarray(images), jcfg)
        return jzoo.cross_entropy(logits[:, None, :], jnp.asarray(labels)[:, None])

    jinit, jupdate = jmake_optimizer(JTrainConfig(**recipe))

    @jax.jit
    def jstep(p):
        jl, grads = jax.value_and_grad(jloss)(p)
        return (jl,) + jupdate(grads, jinit(p), p)

    jl, jparams, jopt, jm = jstep(params)

    tinit, tupdate = make_optimizer(TrainConfig(**recipe))
    named = dict(model.named_parameters())
    logits = tresnet.apply_cnn(model, torch.from_numpy(images))
    loss = tzoo.cross_entropy(logits[:, None, :], torch.from_numpy(labels)[:, None])
    loss.backward()
    _, topt, tm = tupdate({k: p.grad for k, p in named.items()}, tinit(named), named)

    _close(loss.item(), float(jl), rtol=1e-5)
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
    assert tm["lr"] == float(jm["lr"])
    want_params = named_from_tree(jax.tree_util.tree_map(np.asarray, jparams))
    want_mu = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jopt), "cpu").mu
    assert topt.step == int(jopt.step) == 1
    for k, p in named.items():
        _close(p.detach().numpy(), want_params[k])
        _close(topt.mu[k].numpy(), want_mu[k].numpy())


@pytest.mark.parametrize("size,stride", [(8, 2), (7, 2), (8, 1), (5, 1)])
@pytest.mark.parametrize("k", [1, 3])
def test_same_padding_matches_xla(size, stride, k):
    """XLA "SAME": a stride-2 3x3 on an even input pads (0, 1)."""
    rng = np.random.default_rng(size * 10 + stride + k)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    want = jresnet.conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = tresnet.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    _close(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5)


def test_cross_entropy_matches_jax_and_masks_everything_to_zero():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 1, 9)).astype(np.float32)
    labels = rng.integers(-1, 9, size=(6, 1)).astype(np.int32)
    want = jzoo.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tzoo.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(float(got), float(want), rtol=1e-6)
    masked = torch.full((6, 1), -1, dtype=torch.int32)
    assert float(tzoo.cross_entropy(torch.from_numpy(logits), masked)) == 0.0


def test_groupnorm_groups_divide_channels():
    assert [tresnet._groups(c) for c in (3, 4, 6, 12, 64, 10)] == [3, 4, 6, 6, 8, 5]
