"""Data parallelism of the port (latentsplat_tpu_torch.parallel) on the CPU,
two ranks over gloo, against one process and the JAX package:

  * a 2-rank train step of the tiny VAE-GAN (PatchGAN, LPIPS, the spike
    guard, every loss live at step 125000) equals the one-process step on
    the 2-scene batch with the same noise: updated parameters and Adam
    state, both adaptive weights' inputs (the weight and generator/total),
    the gradient norms and the guards; a second step whose loss is
    non-finite on rank 1 alone is skipped by both; both ranks hold the same
    bits after every step;
  * the synchronized PatchGAN BatchNorm on 2 ranks against the JAX
    discriminator on the global batch, logits and gradients;
  * the toy SGD step of tests/test_parallel.py against the JAX
    make_parallel_train_step on a 2-device mesh;
  * `main ... trainer.num_devices=2`: checkpoints written once, and the
    deterministic validation image of the trained weights against the JAX
    trainer's `_render_full` with the same weights;
  * the view-parallel render on [cpu, cpu] against the plain render and the
    JAX dense render;
  * the mesh utilities, a failing rank and a hung one.

Each spawn has a join time limit, so a hung collective fails the test.
"""

import dataclasses
import json
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.multiprocessing as torch_mp

import jax
import jax.numpy as jnp

from latentsplat_tpu.config import load_config as jax_load_config
from latentsplat_tpu.model.discriminator.patch_gan import DiscriminatorPatchGan as JPatchGan
from latentsplat_tpu.model.discriminator.patch_gan import DiscriminatorPatchGanCfg as JPatchGanCfg
from latentsplat_tpu.ops.gaussians import build_covariance as j_build_covariance
from latentsplat_tpu.ops.rasterize import render as j_render
from latentsplat_tpu.parallel import make_mesh as j_make_mesh
from latentsplat_tpu.parallel import make_parallel_train_step as j_make_parallel_train_step
from latentsplat_tpu.parallel import shard_batch as j_shard_batch
from latentsplat_tpu.training.trainer import Trainer as JaxTrainer
from latentsplat_tpu.training.trainer import strip_batch as jax_strip_batch
from latentsplat_tpu_torch import config as tconfig
from latentsplat_tpu_torch.config import DiscriminatorPatchGanCfg, load_config
from latentsplat_tpu_torch.dataset.co3d import DatasetCO3D
from latentsplat_tpu_torch.dataset.re10k import DatasetRE10k
from latentsplat_tpu_torch.dataset.synthetic import DatasetSynthetic
from latentsplat_tpu_torch.dataset.types import RowShard
from latentsplat_tpu_torch.main import main
from latentsplat_tpu_torch.misc.image_io import load_image, prep_image
from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
from latentsplat_tpu_torch.ops.rasterize.api import render
from latentsplat_tpu_torch.parallel import batch_sharding, make_view_parallel_render, shard_batch, spawn
from latentsplat_tpu_torch.parallel.mesh import (
    Mesh, _is_collective_error, check_devices, first_cause, free_port, read_rank_errors,
)
from latentsplat_tpu_torch.training import step as tstep
from latentsplat_tpu_torch.training.checkpointing import load_checkpoint
from latentsplat_tpu_torch.training.trainer import Trainer, strip_batch, to_device
from latentsplat_tpu_torch.weights import params_from_jax

from tests import torch_parallel_ranks as ranks
from tests.test_torch_data import TINY
from tests.test_torch_datasets import CO3D_CASES, RE10K_CASES, _pair, assert_examples_equal
from tests.test_torch_datasets import re10k_root  # noqa: F401 (a fixture)
from tests.torch_jpeg_tools import write_co3d_tree
from tests.test_torch_step_quick import LOSSES, SIZE
from tests.test_torch_training import random_leaves
from tests.test_train_step_quick import _full_cfgs
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

CPU2 = ["cpu", "cpu"]
JOIN_S = 300          # each spawn's join time limit
STEP = 125000
SPIKE_FACTOR = 1e6    # the spike guard runs (EMA, skip count) but never skips here


def views(rng, b, n):
    ext = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    ext[:, :, 0, 3] = np.linspace(-0.3, 0.3, n)
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (b, n, 1, 1))
    return {
        "image": rng.uniform(0, 1, (b, n, SIZE, SIZE, 3)).astype(np.float32),
        "extrinsics": ext, "intrinsics": intr,
        "near": np.full((b, n), 0.5, np.float32), "far": np.full((b, n), 100.0, np.float32),
    }


def step_noise(model, batch, rng):
    """Depth uniforms and Gaussian / latent normals of one step, leading axis b."""
    ctx = {k: torch.from_numpy(v) for k, v in batch["context"].items()}
    shape = model.depth_noise_shape(ctx)
    enc = model.cfg.encoder
    n_gaussians = shape[1] * shape[2] * shape[3] * shape[4]
    d_sh = (enc.gaussian_adapter.feature_sh_degree + 1) ** 2
    c = model.autoencoder.d_latent
    size = model.scaled_size(model.scale_factor, (SIZE, SIZE))
    b, v = batch["target"]["image"].shape[:2]
    return {
        "depth": rng.uniform(0, 1, shape).astype(np.float32),
        "gaussians": rng.standard_normal((b, n_gaussians, c, d_sh)).astype(np.float32),
        "latent": rng.standard_normal((b, v, *size, c)).astype(np.float32),
    }


@contextmanager
def one_thread_ranks():
    """Spawned CPU ranks with one thread each: the test workers already
    share the host's cores, and more threads only contend."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def step_inputs():
    """Step 1 on 2 scenes; step 2 with a NaN in rank 1's target image: the
    ranks' arguments and the one-process reference's results of each step."""
    jcfg = _full_cfgs()[0]
    model_cfg = tconfig.from_dict(tconfig.ModelCfg, dataclasses.asdict(jcfg))
    model_cfg.decoder.backend = "tiled"
    opt_cfg = tconfig.OptimizerCfg(discriminator=tconfig.DiscriminatorOptimizerCfg())
    rng = np.random.default_rng(0)
    batches = [{"context": views(rng, 2, 2), "target": views(rng, 2, 2)} for _ in range(2)]
    batches[1]["target"]["image"][1, 0, 0, 0, 0] = np.nan

    state, losses = ranks.build_state(model_cfg, opt_cfg, LOSSES, "cpu", SPIKE_FACTOR)
    noises = [step_noise(state.model, batch, rng) for batch in batches]
    train_step = tstep.make_train_step(losses, SPIKE_FACTOR)
    reference = []
    for batch, noise in zip(batches, noises):
        state, logs = train_step(state, to_torch(batch), STEP, noise=to_torch(noise))
        reference.append(ranks.results(state, logs))
    return (model_cfg, opt_cfg, LOSSES, batches, noises, STEP, SPIKE_FACTOR), reference


def small_inputs():
    """The PatchGAN (JAX weights, its logits and vjp on the global batch of
    4) and tests/test_parallel.py's toy SGD problem."""
    rng = np.random.default_rng(3)
    jcfg = JPatchGanCfg(base_dim=8, n_layers=3, pretrained=False)
    jmodel = JPatchGan(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = random_leaves(shapes["params"], rng)
    cfg = DiscriminatorPatchGanCfg(**dataclasses.asdict(jcfg))
    weights = params_from_jax(params, DiscriminatorPatchGan(cfg))
    images = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    logits, vjp = jax.vjp(lambda p, x: jmodel.apply({"params": p}, x), params, jnp.asarray(images))
    cotangent = rng.standard_normal(logits.shape).astype(np.float32)
    d_params, d_images = vjp(jnp.asarray(cotangent))
    jax_disc = {"logits": np.asarray(logits), "d_images": np.asarray(d_images),
                "grads": params_from_jax(jax.tree_util.tree_map(np.asarray, d_params), DiscriminatorPatchGan(cfg))}
    toy = (rng.normal(size=(3,)).astype(np.float32),
           {"x": rng.normal(size=(8, 3)).astype(np.float32), "y": rng.normal(size=(8,)).astype(np.float32)})
    return (cfg, weights, images, cotangent, toy), jax_disc, toy


@pytest.fixture(scope="module")
def rank_runs():
    step_args, reference = step_inputs()
    small_args, jax_disc, toy = small_inputs()
    with one_thread_ranks():
        ours = spawn(ranks.every_case, CPU2, "gloo", (step_args, small_args), join_timeout=JOIN_S)
    return reference, ours, jax_disc, toy


@pytest.fixture(scope="module")
def two_rank_run(rank_runs):
    reference, ours, _, _ = rank_runs
    return reference, [rank["steps"] for rank in ours]


@pytest.fixture(scope="module")
def small_run(rank_runs):
    _, ours, jax_disc, toy = rank_runs
    return jax_disc, toy, ours


def relative_error(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |a| (floor 1e-3)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(a.abs().max()), 1e-3))


@pytest.mark.parametrize("aspect", ["parameters", "adam_state", "losses_and_weights", "grad_norms", "guards"])
def test_two_rank_step_equals_one_process_step(two_rank_run, aspect):
    reference, ours = two_rank_run
    ref, rank0 = reference[0], ours[0][0]
    if aspect in ("parameters", "adam_state"):
        prefixes = ("generator.", "discriminator.") if aspect == "parameters" else ("opt_",)
        names = [n for n in ref["params"] if n.startswith(prefixes) and ref["params"][n].is_floating_point()]
        assert names

        def scale(name):
            # Parameters: each leaf's largest value (floor 1e-3). Adam's
            # moments: the largest moment of their kind in the state, since
            # a bias's gradient sums many cancelling terms, and the order in
            # which float32 sums them (two halves averaged, or the whole
            # batch) moves its last digits by more than 1e-6 of its own size.
            if aspect == "parameters":
                return max(float(ref["params"][name].abs().max()), 1e-3)
            kind = ".mu." if ".mu." in name else ".nu."
            return max(float(ref["params"][n].abs().max()) for n in names if kind in n)

        tolerance = 1e-6 if aspect == "parameters" else 1e-5
        errors = {n: float((ref["params"][n].double() - rank0["params"][n].double()).abs().max()) / scale(n)
                  for n in names}
        worst = max(errors, key=errors.get)
        assert errors[worst] < tolerance, (worst, errors[worst])
        counts = [n for n in ref["params"] if n.endswith(".count")]
        assert counts and all(torch.equal(ref["params"][n], rank0["params"][n]) for n in counts)
        return
    keys = {
        "losses_and_weights": ["generator/total", "target_combined/adaptive_weight", "discriminator/total",
                               "target_combined/generator", "target_render_image/mse", "train/target_render/psnr",
                               "diag/max_opacity", "diag/max_world_scale"],
        "grad_norms": [k for k in ref["logs"] if k.startswith("grad_norm/")],
        "guards": ["optimizer/loss_spike_skipped", "optimizer/loss_spike_forced"],
    }[aspect]
    assert keys and set(ref["logs"]) == set(rank0["logs"])
    for key in keys:
        assert rank0["logs"][key] == pytest.approx(ref["logs"][key], rel=1e-6, abs=1e-9), key
    if aspect == "guards":
        for key in ("gen_loss_ema", "spike_skip_count"):
            assert relative_error(ref["params"][key], rank0["params"][key]) < 1e-6, key


def test_ranks_hold_the_same_bits_after_every_step(two_rank_run):
    _, ours = two_rank_run
    for step_results in zip(*ours):
        a, b = step_results
        assert set(a["params"]) == set(b["params"])
        assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
        assert a["logs"].keys() == b["logs"].keys()
        assert all(a["logs"][k] == b["logs"][k] or (np.isnan(a["logs"][k]) and np.isnan(b["logs"][k]))
                   for k in a["logs"])


def test_non_finite_loss_on_one_rank_skips_on_both(two_rank_run):
    reference, ours = two_rank_run
    for results in (reference, *ours):
        assert not np.isfinite(results[1]["logs"]["generator/total"])
        # Nothing moved: parameters, Adam state and counts, the guard's EMA.
        assert all(torch.equal(results[0]["params"][n], results[1]["params"][n]) for n in results[0]["params"])


@pytest.mark.parametrize("output", ["logits", "d_images", "grads"])
def test_sync_batch_norm_patch_gan_matches_jax_global_batch(small_run, output):
    theirs, _, ours = small_run
    if output == "grads":
        for name, ref in theirs["grads"].items():
            for rank in ours:
                np.testing.assert_allclose(rank["disc"]["grads"][name].numpy(), ref.numpy(),
                                           atol=1e-5 * float(ref.abs().max()), err_msg=name)
        return
    ours_global = np.concatenate([rank["disc"][output].numpy() for rank in ours])
    # Batch statistics over the global batch and float32 rounding: 1e-5 of
    # the largest value, as tests/test_torch_training.py's PatchGAN test.
    np.testing.assert_allclose(ours_global, theirs[output], atol=1e-5 * np.abs(theirs[output]).max())


def test_toy_step_matches_jax_parallel_step(small_run):
    _, (params, batch), ours = small_run
    mesh = j_make_mesh(jax.devices()[:2])

    def train_step(state, batch, rng, flags):
        def loss_fn(p):
            return jnp.mean((batch["x"] @ p - batch["y"]) ** 2)

        return state - 0.1 * jax.grad(loss_fn)(state), {"loss": loss_fn(state)}

    new_params, logs = j_make_parallel_train_step(train_step, mesh)(
        jnp.asarray(params), j_shard_batch(batch, mesh), jax.random.PRNGKey(0), None
    )
    for rank in ours:
        np.testing.assert_allclose(rank["toy"]["params"].numpy(), np.asarray(new_params), atol=1e-6)
        assert rank["toy"]["loss"] == pytest.approx(float(logs["loss"]), abs=1e-6)


# -- the program on two ranks -------------------------------------------------------


def params_to_jax(state: dict, template, model):
    """A port state_dict -> the flax tree laid out like `template`: every
    JAX element's place in the port's tensors is found by sending the
    elements' indices through params_from_jax (exact in float32 below 2^24
    elements)."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    sizes = [int(np.size(x)) for x in leaves]
    assert sum(sizes) < 2**24
    offsets = np.cumsum([0] + sizes)
    indices = [np.arange(o, o + n, dtype=np.float32).reshape(np.shape(x)) for o, n, x in zip(offsets, sizes, leaves)]
    where = params_from_jax(jax.tree_util.tree_unflatten(treedef, indices), model)
    flat = np.full(offsets[-1], np.nan, np.float32)
    for key, idx in where.items():
        flat[idx.numpy().astype(np.int64).reshape(-1)] = state[key].numpy().reshape(-1)
    assert not np.isnan(flat).any()
    return jax.tree_util.tree_unflatten(
        treedef, [flat[o : o + n].reshape(np.shape(x)) for o, n, x in zip(offsets, sizes, leaves)]
    )


@pytest.fixture(scope="module")
def main_two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("main2")
    argv = TINY + [f"output_dir={out}", f"test.output_path={out}/test", "trainer.num_devices=2",
                   "trainer.max_steps=3", "checkpointing.every_n_train_steps=2", "trainer.val_check_interval=3"]
    start = time.perf_counter()
    with one_thread_ranks():
        run = main(argv, device="cpu")
    return out, run, time.perf_counter() - start


def test_main_trains_on_two_ranks_and_writes_checkpoints_once(main_two_ranks):
    _, run, _ = main_two_ranks
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["latest", "step_00000002", "step_00000003"]
    records = [json.loads(line) for line in (run / "local" / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in records if "generator/total" in r]
    assert steps == [1, 2, 3] and all(np.isfinite(r["generator/total"]) for r in records if "generator/total" in r)
    assert load_checkpoint(run / "checkpoints" / "step_00000003")["step"] == 3


def test_torchrun_ranks_leave_the_group_before_rank_0_tests(tmp_path):
    # Under torchrun rank 0 tests alone after fit. Its test is held for
    # longer than the group's collective timeout: a rank still waiting on
    # it in a collective would raise and fail the launch.
    out = tmp_path / "run"
    argv = TINY + [f"output_dir={out}", f"test.output_path={out}/test", "trainer.max_steps=1",
                   "trainer.val_check_interval=0"]
    with one_thread_ranks():
        context = torch_mp.start_processes(ranks.torchrun_rank, args=(2, free_port(), argv, 12.0, 6.0), nprocs=2,
                                           join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not context.join(timeout=1.0):
            assert time.monotonic() < deadline, "the torchrun ranks did not finish"
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
                process.join()
    run = out / "latest-run"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["latest", "step_00000001"]
    assert list((out / "test").rglob("*.png"))


def test_main_validation_image_matches_jax(main_two_ranks, tmp_path):
    # Rank 0's validation at step 3 renders the trained generator; its
    # deterministic row is the port's render of the step-3 checkpoint, and
    # that render matches the JAX trainer's deterministic `_render_full`
    # with the same weights (the JAX side dense, the port tiled) within the
    # 2e-3 of tests/test_torch_trainer.py::test_validation_image_matches_jax.
    out, run, _ = main_two_ranks
    cfg = load_config(None, TINY + [f"output_dir={tmp_path}"])
    ours = Trainer(cfg, tmp_path / "port", device="cpu")
    ours.model.load_state_dict(load_checkpoint(run / "checkpoints" / "step_00000003")["generator"])
    raw = next(ours._loader("val", 1, repeat=False))
    image = ours._render_full(ours.model, to_device(strip_batch(raw), torch.device("cpu")), None, True)["image"]

    grid = load_image(run / "local" / "comparison" / "000003.png")
    row = prep_image(np.concatenate(list(image[0].numpy()), axis=1)) / np.float32(255.0)
    # add_border(vcat(label + gt, label + probabilistic, label + deterministic)): the last row, 8 px border.
    np.testing.assert_array_equal(grid[-8 - 32 : -8, 8 : 8 + 32], row)

    theirs = JaxTrainer(jax_load_config(None, TINY + ["model.decoder.backend=dense"]), tmp_path / "jax")
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_strip_batch(raw))
    template = theirs.model.init_params(jax.random.PRNGKey(cfg.seed), theirs.data_shim(jbatch))["generator"]
    params = params_to_jax({k: v for k, v in ours.model.state_dict().items()}, template, ours.model)
    ref = np.asarray(theirs._render_full(params, jbatch, jax.random.PRNGKey(0), True)["image"])
    np.testing.assert_allclose(image.numpy(), ref, rtol=0, atol=2e-3)


# -- each rank's rows of the data ----------------------------------------------------


def fresh_dataset(name, tmp_path, roots):
    """A new train-stage dataset with augmentation, from the same seeds."""
    if name == "synthetic":
        return Trainer(load_config(None, TINY), tmp_path, device="cpu")._dataset("train")
    if name == "re10k":
        kw = dict(RE10K_CASES["train-augment-bounded"])
        from latentsplat_tpu.dataset.re10k import DatasetRE10k as JDataset
        from latentsplat_tpu.dataset.types import DatasetRE10kCfg as JCfg
        from latentsplat_tpu_torch.dataset.types import DatasetRE10kCfg as Cfg
        return _pair(DatasetRE10k, JDataset, Cfg, JCfg, kw.pop("stage"), kw.pop("spec"),
                     roots=[str(roots["re10k"])], **kw)[0]
    root = roots["co3d"]
    split = root / "split.json"
    kw = dict(CO3D_CASES["train-augment-bounded"])
    from latentsplat_tpu.dataset.co3d import DatasetCO3D as JDataset
    from latentsplat_tpu.dataset.types import DatasetCO3DCfg as JCfg
    from latentsplat_tpu_torch.dataset.types import DatasetCO3DCfg as Cfg
    return _pair(DatasetCO3D, JDataset, Cfg, JCfg, kw.pop("stage"), kw.pop("spec"), image_shape=[32, 32],
                 roots=[str(root)], train_split_json=str(split), eval_split_json=str(split), **kw)[0]


@pytest.mark.parametrize("name", ["synthetic", "re10k", "co3d"])
def test_ranks_read_only_their_rows_of_the_one_process_order(name, tmp_path, monkeypatch, re10k_root):
    # 2 ranks of b rows each, over two passes whose length is not a whole
    # number of global batches: in each pass rank r takes rows rb .. rb + b - 1
    # of every 2b of the one-process order, with its flips and view draws,
    # decodes (or renders) only its own rows, and drops the pass's last,
    # incomplete global batch. (The CO3D tree of fixture frames has no
    # damaged frame: a frame that fails to decode drops its row on its own
    # rank alone, which the one-process order cannot show.)
    roots = {"re10k": re10k_root}
    if name == "co3d":
        roots["co3d"] = tmp_path / "co3d"
        write_co3d_tree(roots["co3d"], sequences=4, frames=12)
    one = fresh_dataset(name, tmp_path / "whole", roots)
    passes = [list(one), list(one)]   # one dataset's rng goes on from pass to pass
    assert min(len(p) for p in passes) >= 4
    b = next(b for b in (2, 3, 1) if all(len(p) % (2 * b) for p in passes))
    reads = []
    cls, method = {"synthetic": (DatasetSynthetic, "_make_sample"), "re10k": (DatasetRE10k, "_convert_images"),
                   "co3d": (DatasetCO3D, "_load_image")}[name]
    original = getattr(cls, method)

    def counted(*args, **kwargs):
        reads.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(cls, method, staticmethod(counted) if name == "re10k" else counted)
    per_view = {"synthetic": 1, "re10k": 2, "co3d": 4}[name]   # calls per row
    for rank in range(2):
        dataset = fresh_dataset(name, tmp_path / f"rank{rank}", roots)
        shard = dataset.row_shard = RowShard(b * rank, b * (rank + 1), 2 * b)
        for whole in passes:
            reads.clear()
            rows = list(dataset)
            complete = len(whole) - len(whole) % (2 * b)
            assert len(rows) == b * complete // (2 * b)
            assert_examples_equal(rows, [e for i, e in enumerate(whole[:complete]) if shard.keeps(i)])
            assert len(reads) == per_view * sum(shard.keeps(i) for i in range(len(whole)))


# -- view-parallel render -------------------------------------------------------------


def view_scene(v=8, n=32):
    ks = jax.random.split(jax.random.PRNGKey(7), 6)
    xy = jax.random.uniform(ks[0], (n, 2), minval=-0.4, maxval=0.4)
    z = jax.random.uniform(ks[1], (n,), minval=2.0, maxval=5.0)
    means = jnp.concatenate([xy * z[:, None], z[:, None]], axis=-1)
    covs = j_build_covariance(jax.random.uniform(ks[2], (n, 3), minval=0.05, maxval=0.15),
                              jax.random.normal(ks[3], (n, 4)))
    cams = {
        "extrinsics": jnp.tile(jnp.eye(4)[None, None], (1, v, 1, 1)).at[0, :, 0, 3].set(jnp.linspace(-0.2, 0.2, v)),
        "intrinsics": jnp.tile(jnp.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]])[None, None], (1, v, 1, 1)),
        "near": jnp.full((1, v), 0.5), "far": jnp.full((1, v), 20.0),
    }
    gauss = {
        "background_color": jnp.zeros((1, 3)), "gaussian_means": means[None], "gaussian_covariances": covs[None],
        "gaussian_opacities": jax.random.uniform(ks[4], (n,), minval=0.3, maxval=0.9)[None],
        "gaussian_color_sh": jax.random.normal(ks[5], (n, 3, 1))[None] * 0.3,
        "gaussian_feature_sh": jax.random.normal(ks[5], (n, 2, 1))[None] * 0.3,
    }
    return cams, gauss


def test_view_parallel_render_matches_plain_and_jax_dense():
    cams, gauss = view_scene()
    t = lambda tree: {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}  # noqa: E731
    out = make_view_parallel_render(["cpu", "cpu"], (16, 16))(t(cams), t(gauss))
    plain = render(*(t(cams)[k] for k in ("extrinsics", "intrinsics", "near", "far")), (16, 16), **t(gauss))
    for name in ("color", "feature", "mask", "depth", "num_pairs"):
        assert torch.equal(getattr(out, name), getattr(plain, name)), name
    dense = j_render(cams["extrinsics"], cams["intrinsics"], cams["near"], cams["far"], (16, 16),
                     backend="dense", **gauss)
    # The tiled render against the dense one: tests/test_rasterize.py's 2e-4.
    for name in ("color", "mask"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(dense, name)), atol=2e-4)
    with pytest.raises(ValueError, match="do not split over 3 devices"):
        make_view_parallel_render(["cpu"] * 3, (16, 16))(t(cams), t(gauss))


# -- mesh utilities and failures -------------------------------------------------------


def test_shard_batch_splits_the_leading_axis():
    batch = {"x": np.arange(24, dtype=np.float32).reshape(8, 3), "v": {"y": torch.arange(8)}, "scene": list("abcdefgh")}
    shards = [shard_batch(batch, Mesh(r, 4, torch.device("cpu"))) for r in range(4)]
    assert [s["scene"] for s in shards] == [["a", "b"], ["c", "d"], ["e", "f"], ["g", "h"]]
    np.testing.assert_array_equal(torch.cat([s["x"] for s in shards]).numpy(), batch["x"])
    assert torch.equal(torch.cat([s["v"]["y"] for s in shards]), batch["v"]["y"])
    assert batch_sharding(Mesh(1, 2, torch.device("cpu")), 6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        batch_sharding(Mesh(0, 4, torch.device("cpu")), 6)


def test_nccl_refuses_two_ranks_on_one_card_and_the_cpu():
    with pytest.raises(ValueError, match=r"2 ranks on cuda:0 .*gloo"):
        check_devices([torch.device("cuda:0"), torch.device("cuda:0")], "nccl")
    with pytest.raises(ValueError, match="CUDA devices only"):
        check_devices([torch.device("cpu")] * 2, "nccl")
    check_devices([torch.device("cuda:0"), torch.device("cuda:0")], "gloo")


def test_a_failed_rank_fails_the_run():
    # The run fails with rank 1's own error, never rank 0's lost connection to it.
    with pytest.raises(torch_mp.ProcessRaisedException, match="rank 1 failed on purpose"):
        with one_thread_ranks():
            spawn(ranks.rank_fails, CPU2, "gloo", join_timeout=JOIN_S)


def write_err(root, rank: int, at: float, collective: bool, message: str) -> None:
    (root / f"rank_{rank}.err").write_text(json.dumps(
        {"rank": rank, "time": at, "collective": collective, "traceback": message}))


def test_a_failed_run_reports_the_rank_that_caused_it(tmp_path):
    # Rank 0's collective lost its peer first; rank 1's own error came later.
    write_err(tmp_path, 0, 10.0, True, "RuntimeError: [gloo] Read error: Connection reset by peer")
    write_err(tmp_path, 1, 10.5, False, "RuntimeError: rank 1 failed on purpose")
    records = read_rank_errors(tmp_path)
    assert [r["rank"] for r in records] == [0, 1]
    assert first_cause(records)["traceback"] == "RuntimeError: rank 1 failed on purpose"
    # Only collective errors: the earliest.
    (tmp_path / "rank_1.err").unlink()
    write_err(tmp_path, 2, 9.0, True, "RuntimeError: Connection closed by peer")
    assert first_cause(read_rank_errors(tmp_path))["rank"] == 2
    assert first_cause([]) is None


def test_collective_errors_are_told_from_a_rank_s_own():
    def raised(fn):
        try:
            fn()
        except Exception as exc:
            return exc

    mesh = Mesh(0, 2, torch.device("cpu"), group=object())
    assert not _is_collective_error(raised(lambda: ranks.rank_fails(Mesh(1, 2, torch.device("cpu")))))
    assert _is_collective_error(raised(lambda: mesh.barrier()))   # inside torch.distributed and a Mesh method
    assert _is_collective_error(RuntimeError("[../gloo/transport/tcp/pair.cc:534] Read error [::1]:4242: "
                                             "Connection reset by peer"))
    assert not _is_collective_error(RuntimeError("CUDA out of memory"))


def test_a_hung_rank_fails_the_run():
    start = time.perf_counter()
    with pytest.raises(TimeoutError, match="did not finish within 5 s"), one_thread_ranks():
        spawn(ranks.rank_hangs, CPU2, "gloo", join_timeout=5)
    assert time.perf_counter() - start < 30
