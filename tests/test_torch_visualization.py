"""The port's camera trajectories, color maps and validation videos against
the JAX package's: trajectories and color maps within 1e-6 on the same
inputs; `Trainer.render_video` frames with the same weights, both
rendering deterministically: images within 2e-3, depths within 2e-3 of
their largest value."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from latentsplat_tpu.config import load_config as jax_load_config
from latentsplat_tpu.training.trainer import Trainer as JaxTrainer
from latentsplat_tpu.training.trainer import strip_batch as jax_strip_batch
from latentsplat_tpu.visualization import camera_trajectory as jax_trajectory
from latentsplat_tpu.visualization import color_map as jax_color_map
from latentsplat_tpu_torch.training.trainer import Trainer, strip_batch
from latentsplat_tpu_torch.visualization import camera_trajectory, color_map
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_trainer import tiny_cfg
from tests.test_torch_data import TINY
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL = 1e-6


def random_pose(rng, spread=0.6):
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = Rotation.from_rotvec(rng.uniform(-spread, spread, 3)).as_matrix()
    ext[:3, 3] = rng.uniform(-1.0, 1.0, 3)
    return ext


def eased(n):
    t = np.linspace(0, 1, n, dtype=np.float32)
    return (np.cos(np.pi * (t + 1)) + 1) / 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolate_extrinsics_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = random_pose(rng), random_pose(rng)
    ours = camera_trajectory.interpolate_extrinsics(a, b, eased(30))
    theirs = jax_trajectory.interpolate_extrinsics(a, b, eased(30))
    assert ours.shape == (30, 4, 4) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours[0], a, atol=1e-4)
    np.testing.assert_allclose(ours[-1], b, atol=1e-4)


def test_interpolate_extrinsics_parallel_and_batched_match_jax():
    rng = np.random.default_rng(3)
    a = np.stack([random_pose(rng) for _ in range(2)])
    b = a.copy()
    b[0, :3, 3] += [0.5, 0.0, 0.0]           # the same look: pivots about the midpoint
    b[1] = random_pose(rng)
    ours = camera_trajectory.interpolate_extrinsics(a, b, eased(7))
    np.testing.assert_allclose(ours, jax_trajectory.interpolate_extrinsics(a, b, eased(7)), rtol=0, atol=ATOL)
    assert ours.shape == (2, 7, 4, 4)


def test_interpolate_intrinsics_matches_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(0.2, 1.2, (2, 3, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        camera_trajectory.interpolate_intrinsics(a, b, eased(9)),
        jax_trajectory.interpolate_intrinsics(a, b, eased(9)), rtol=0, atol=ATOL,
    )


def test_wobble_and_spin_match_jax():
    rng = np.random.default_rng(5)
    ext = random_pose(rng)
    np.testing.assert_allclose(
        camera_trajectory.generate_wobble(ext, np.asarray(0.3), eased(30)),
        jax_trajectory.generate_wobble(ext, np.asarray(0.3), eased(30)), rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        camera_trajectory.generate_wobble_transformation(np.asarray([0.1, 0.4]), eased(5), num_rotations=2),
        jax_trajectory.generate_wobble_transformation(np.asarray([0.1, 0.4]), eased(5), num_rotations=2),
        rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        camera_trajectory.generate_spin(12, 20.0, 2.5), jax_trajectory.generate_spin(12, 20.0, 2.5),
        rtol=0, atol=ATOL,
    )


@pytest.mark.parametrize("name", ["turbo", "gray", "inferno"])
def test_color_maps_match_jax(name):
    x = np.random.default_rng(6).uniform(-0.2, 1.2, (7, 9)).astype(np.float32)
    ours = color_map.apply_color_map_to_image(x, name)
    assert ours.shape == (7, 9, 3)
    np.testing.assert_allclose(ours, jax_color_map.apply_color_map_to_image(x, name), rtol=0, atol=ATOL)


@pytest.mark.parametrize("near, far, invert", [(None, None, True), (0.5, 20.0, False)])
def test_depth_color_map_matches_jax(near, far, invert):
    depth = np.random.default_rng(7).uniform(0.3, 30.0, (16, 12)).astype(np.float32)
    depth[0, 0] = 0.0
    np.testing.assert_allclose(
        color_map.apply_depth_color_map(depth, near, far, invert),
        jax_color_map.apply_depth_color_map(depth, near, far, invert), rtol=0, atol=ATOL,
    )


def test_color_map_2d_matches_jax():
    rng = np.random.default_rng(8)
    x, y = rng.uniform(0, 1, (5, 6)), rng.uniform(0, 1, (5, 6))
    np.testing.assert_allclose(color_map.apply_color_map_2d(x, y), jax_color_map.apply_color_map_2d(x, y),
                               rtol=0, atol=ATOL)


# -- validation videos -----------------------------------------------------------------


def record_videos(trainer, monkeypatch):
    """Replace the trainer's logger's log_video with one that keeps the
    frames: {key: [frames]}."""
    videos = {}
    monkeypatch.setattr(trainer.logger, "log_video", lambda key, frames, step: videos.setdefault(key, frames))
    return videos


def deterministic(trainer_cls, monkeypatch):
    """The trainer renders its videos through `_render_full` with
    deterministic=True, so that no random numbers are drawn; returns the
    list into which each render's output goes."""
    original, outputs = trainer_cls._render_full, []

    def render(self, params, batch, rng, det):
        outputs.append(original(self, params, batch, rng, True))
        return outputs[-1]

    monkeypatch.setattr(trainer_cls, "_render_full", render)
    return outputs


@pytest.mark.parametrize("backend", ["dense", "tiled"])
@pytest.mark.parametrize("mode", ["wobble", "interpolation"])
def test_render_video_matches_jax(tmp_path, monkeypatch, mode, backend):
    # The tiny trainer's val batch and the JAX trainer's generator weights
    # (mapped with params_from_jax); the JAX side renders with the dense
    # backend, the port with its dense and its tiled one. Each frame is the
    # image over its depth in color: the image is held to 2e-3, the
    # validation image's tolerance (tests/test_torch_trainer.py), and the
    # depth to 2e-3 of its largest value, the depth tolerance of
    # tests/test_rasterize.py. (The encoders' triangulated depths differ by
    # float rounding, which moves a few pixels' depth by ~2e-3 of the
    # largest; the color map, normalised by the depth's own range, turns
    # that into ~5e-3 of color, so the depth panel is held as the port's own
    # depth in color.)
    cfg = tiny_cfg(tmp_path, [f"model.decoder.backend={backend}"])
    ours = Trainer(cfg, tmp_path / "port", device="cpu")
    theirs = JaxTrainer(jax_load_config(None, TINY + ["model.decoder.backend=dense"]), tmp_path / "jax")
    raw = next(ours._loader("val", 1, repeat=False))
    jbatch = jax.tree_util.tree_map(jnp.asarray, jax_strip_batch(raw))
    params = theirs.model.init_params(jax.random.PRNGKey(cfg.seed), theirs.data_shim(jbatch))["generator"]
    ours.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.array, params), ours.model), strict=True)
    our_out, their_out = deterministic(Trainer, monkeypatch), deterministic(JaxTrainer, monkeypatch)
    our_videos, their_videos = record_videos(ours, monkeypatch), record_videos(theirs, monkeypatch)

    ours.render_video(ours.model, strip_batch(raw), mode, 3, num_frames=6)
    theirs.render_video(params, jax_strip_batch(raw), mode, 3, num_frames=6)
    key = f"video/{mode}"
    assert list(our_videos) == list(their_videos) == [key]
    assert len(our_videos[key]) == len(their_videos[key]) == 6 + 4     # looped back
    depth, their_depth = our_out[0]["depth"][0].numpy(), np.asarray(their_out[0]["depth"][0])
    assert np.abs(depth - their_depth).max() <= 2e-3 * np.abs(their_depth).max()
    for i, (a, b) in enumerate(zip(our_videos[key], their_videos[key])):
        assert a.shape == b.shape == (32 + 2 + 32, 32, 3)
        np.testing.assert_allclose(a[:32], b[:32], rtol=0, atol=2e-3)
        v = i if i < 6 else 10 - i
        np.testing.assert_allclose(a[34:], color_map.apply_depth_color_map(depth[v]), rtol=0, atol=ATOL)


def test_validate_renders_both_videos(tmp_path, monkeypatch):
    cfg = tiny_cfg(tmp_path, ["train.video_wobble=true", "train.video_interpolation=true"])
    trainer = Trainer(cfg, tmp_path, device="cpu")
    log_video, videos = trainer.logger.log_video, {}

    def record(key, frames, step):
        videos[key] = frames
        log_video(key, frames, step)

    monkeypatch.setattr(trainer.logger, "log_video", record)
    trainer.validate_params(trainer.model, step=5)
    assert list(videos) == ["video/wobble", "video/interpolation"]
    for key, frames in videos.items():
        assert len(frames) == 30 + 28
        assert all(f.shape == (66, 32, 3) and np.isfinite(f).all() for f in frames)
        # Without ffmpeg the frames are PNGs in a folder beside the mp4's path.
        video = tmp_path / "local" / key / "000005.mp4"
        assert video.exists() or len(list(video.with_suffix("").glob("*.png"))) == 58
