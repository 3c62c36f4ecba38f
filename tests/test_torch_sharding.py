"""The port's pixel and sample windows against the JAX package's sharded
renderers on the virtual 8-device CPU mesh, in one process.

The port renders one window a rank (``pool._pool_loop`` and
``render.render_batch``); here every window of a ``(dp, sp)`` mesh is
rendered in turn and the sample windows summed by hand, as the ranks'
``all_reduce`` would. The JAX side runs its CPU default (the pool's composed
branch); the port runs its main path (the fused branch on the kernels'
plain twins). Ray counts and each window's iterations are exact, images
within the ``tests/imgutil.py`` knife-edge budget. At ``sp=1`` the windows
give the port's single-process image bit for bit. Multi-process runs over
``torch.distributed`` are in ``tests/test_torch_distributed.py``.
"""

import dataclasses
import datetime
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pathtrace_tpu import pool as jax_pool  # noqa: E402
from pathtrace_tpu.models import scenes as jax_scenes  # noqa: E402
from pathtrace_tpu.parallel import sharding as jax_sharding  # noqa: E402
from pathtrace_tpu.render import RenderConfig as JaxConfig  # noqa: E402
from pathtrace_tpu_torch import pool  # noqa: E402
from pathtrace_tpu_torch.convert import (  # noqa: E402
    camera_from_arrays,
    scene_from_arrays,
    split_fields,
)
from pathtrace_tpu_torch.ops import intersect  # noqa: E402
from pathtrace_tpu_torch.parallel import distributed, sharding  # noqa: E402
from pathtrace_tpu_torch.render import (  # noqa: E402
    RenderConfig,
    pixel_grid,
    render,
    render_batch,
)
from pathtrace_tpu_torch.utils import rng  # noqa: E402

from .imgutil import assert_images_match  # noqa: E402

W = H = 16
POOL = dict(width=W, height=H, spp=4, integrator="mis", max_bounces=5, num_slots=64, seed=9)


@pytest.fixture(scope="module")
def jax_scene():
    return jax_scenes.cornell_box()


@pytest.fixture(scope="module")
def scene(jax_scene):
    return scene_from_arrays(*split_fields(jax_scene), device="cpu")


def _cams(n=1):
    jcam = jax_scenes.cornell_camera(W, H)
    jcams = [dataclasses.replace(jcam, origin=jcam.origin + jnp.asarray([0.02 * i, 0.0, 0.0]))
             for i in range(n)]
    return jcams, [camera_from_arrays(*split_fields(c), device="cpu") for c in jcams]


def _jax_mesh(dp, sp):
    return jax_sharding.make_mesh(jax.devices()[:dp * sp], dp=dp, sp=sp)


def _pool_windows(scene, camera, dp, sp, method=None, **kw):
    """Every window of a (dp, sp) mesh, summed over sp by hand:
    ``(image (H*W, 3), rays, iters (dp, sp))``."""
    n = kw["width"] * kw["height"]
    local = -(-n // dp)
    spp = kw.pop("spp")
    parts, rays, iters = [], 0, np.zeros((dp, sp), np.int64)
    for d in range(dp):
        acc = None
        for s in range(sp):
            img, counters, it = pool._pool_loop(
                scene, camera, d * local, s * (spp // sp), total_pixels=n, local_pixels=local,
                spp=spp // sp, method=method, **kw)
            acc = img if acc is None else acc + img
            rays += pool.ray_count(counters)
            iters[d, s] = it
        parts.append(acc)
    return torch.cat(parts)[:n], rays, iters


@pytest.mark.parametrize("dp,sp", [(4, 2), (2, 4), (6, 1)])
def test_pool_windows_match_jax_render_pool_sharded(jax_scene, scene, dp, sp):
    """(6, 1): 256 pixels in windows of 43, the last overhanging the frame."""
    (jcam,), (cam,) = _cams()
    img, counters, iters = jax_sharding.render_pool_sharded(
        jax_scene, jcam, mesh=_jax_mesh(dp, sp), **POOL)
    got, rays, got_iters = _pool_windows(scene, cam, dp, sp, **POOL)
    assert rays == jax_pool.ray_count(counters)
    np.testing.assert_array_equal(got_iters, np.asarray(iters))
    assert_images_match(got.numpy(), np.asarray(img))


@pytest.mark.parametrize("dp,method", [(6, None), (3, None), (4, "bruteforce")])
def test_pool_windows_sp1_bitwise(scene, dp, method):
    """Under dp alone each pixel's samples run in sample order in one slot,
    on either branch: the single-process image bit for bit."""
    _, (cam,) = _cams()
    ref, counters, _ = pool.render_pool(scene, cam, method=method, **POOL)
    got, rays, _ = _pool_windows(scene, cam, dp, 1, method=method, **POOL)
    assert rays == pool.ray_count(counters)
    assert torch.equal(got, ref)


def test_wave_windows_match_jax_render_sharded(jax_scene, scene, dp=3, sp=2):
    """(3, 2): 256 pixels padded to 258 with pixel 0, two sample windows."""
    (jcam,), (cam,) = _cams()
    cfg = dict(width=W, height=H, spp=4, integrator="mis", max_bounces=5, seed=9)
    ref = jax_sharding.render_sharded(jax_scene, jcam, JaxConfig(**cfg), _jax_mesh(dp, sp))
    ids = sharding._pad_to(pixel_grid(W, H), dp)
    local = ids.shape[0] // dp
    key, tables = rng.base_key(cfg["seed"]), intersect.build_tables(scene)
    parts = []
    for d in range(dp):
        parts.append(sum(render_batch(
            scene, cam, ids[d * local:(d + 1) * local], s * (4 // sp), key, width=W, height=H,
            integrator="mis", max_bounces=5, samples_per_batch=4 // sp, tables=tables)[0]
            for s in range(sp)))
    got = torch.cat(parts)[:W * H].reshape(H, W, 3)
    assert_images_match(got.numpy(), np.asarray(ref.image_sum))


def test_frames_pool_one_process_matches_render_pool_and_jax(jax_scene, scene):
    """World size 1 (the 1x1 mesh; ``chunk_frames``, kept for the JAX
    signature, changes nothing): each frame is its ``render_pool`` bit for bit; against JAX on a (4, 2) mesh the
    per-frame rays are exact."""
    jcams, cams = _cams(3)
    cfg = RenderConfig(width=W, height=H, spp=4, integrator="mis", max_bounces=5, seed=3)
    frames, counters, iters = sharding.frames_pool_sharded(scene, cams, cfg, num_slots=64,
                                                           chunk_frames=2)
    assert frames.shape == (3, H, W, 3) and counters.shape == (3, 1, 4) and iters.shape == (3, 1)
    for f, cam in enumerate(cams):
        img, ctr, it = pool.render_pool(scene, cam, num_slots=64, **{
            k: getattr(cfg, k) for k in ("width", "height", "spp", "integrator",
                                         "max_bounces", "seed")})
        assert torch.equal(frames[f], img.reshape(H, W, 3) / 4)
        assert pool.ray_count(counters[f]) == pool.ray_count(ctr) and iters[f, 0] == it
    jcfg = JaxConfig(width=W, height=H, spp=4, integrator="mis", max_bounces=5, seed=3)
    jframes, jcounters, _ = jax_sharding.frames_pool_sharded(
        jax_scene, jcams, jcfg, _jax_mesh(4, 2), num_slots=64)
    for f in range(3):
        assert pool.ray_count(counters[f]) == jax_pool.ray_count(jcounters[f])
        assert_images_match(frames[f].numpy(), np.asarray(jframes[f]))


def test_wave_sharded_one_process_matches_render(scene):
    _, cams = _cams(2)
    cfg = RenderConfig(width=W, height=H, spp=2, max_bounces=5, seed=4,
                              samples_per_batch=2)
    state = sharding.render_sharded(scene, cams[0], cfg)
    ref = render(scene, cams[0], cfg)
    assert torch.equal(state.image_sum, ref.image_sum) and state.num_samples == 2
    assert state.ray_queries == ref.ray_queries
    frames = sharding.frames_sharded(scene, cams, cfg)
    for f, cam in enumerate(cams):
        assert torch.equal(frames[f], render(scene, cam, cfg).image)


def test_mesh_layout_is_node_major_and_refuses_what_jax_refuses():
    assert distributed.mesh_layout(["a", "b", "a", "b"], sp=2).tolist() == [[0, 2], [1, 3]]
    assert distributed.mesh_layout(["a"] * 4 + ["b"] * 4, dp=2, sp=4).shape == (2, 4)
    with pytest.raises(ValueError, match="host-contained"):
        distributed.mesh_layout(["a"] * 3 + ["b"] * 3, sp=2)
    with pytest.raises(ValueError, match="mesh 3x2 != 8 ranks"):
        distributed.mesh_layout(["a"] * 8, dp=3, sp=2)
    with pytest.raises(ValueError, match="mesh 2x0 != 1 ranks"):
        sharding.make_mesh(dp=2)
    assert sharding.make_mesh().shape == {"dp": 1, "sp": 1}


def test_spp_must_divide_by_sp(jax_scene, scene):
    (jcam,), (cam,) = _cams()
    mesh = distributed.Mesh(np.arange(2).reshape(1, 2), (0, 0))
    kw = dict(POOL, spp=3)
    with pytest.raises(ValueError, match="spp=3 must divide by sample-axis size 2"):
        sharding.render_pool_sharded(scene, cam, mesh=mesh, **kw)
    with pytest.raises(ValueError, match="spp=3 must divide by sample-axis size 2"):
        jax_sharding.render_pool_sharded(jax_scene, jcam, mesh=_jax_mesh(1, 2), **kw)
    cfg = RenderConfig(width=W, height=H, spp=3)
    for fn in (sharding.render_sharded, sharding.frames_sharded, sharding.frames_pool_sharded):
        with pytest.raises(ValueError, match="must divide"):
            fn(scene, cam if fn is sharding.render_sharded else [cam], cfg, mesh)


def test_initialize_is_a_no_op_without_a_request(monkeypatch):
    for name in ("PT_COORDINATOR", "PT_NUM_PROCESSES", "PT_PROCESS_ID", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize(device="cpu")
    assert not distributed.is_distributed() and distributed.process_index() == 0
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="not a rank of 2"):
        distributed.initialize("127.0.0.1:1", 2, 2, device="cpu")


@pytest.mark.parametrize("n_gpus, hosts, backend", [
    (4, ["node0"] * 4, "nccl"),                   # a 4-GPU node, a GPU a rank
    (4, ["node0"] * 4 + ["node1"] * 4, "nccl"),   # two such nodes, global ranks
    (1, ["node0"] * 2, "gloo"),                   # two ranks share a one-GPU node
    (4, ["node0"] * 4 + ["node1"] * 8, "gloo"),   # one node oversubscribed: every rank gloo
])
def test_initialize_places_ranks_from_the_layout(monkeypatch, capsys, n_gpus, hosts, backend):
    """Without ``LOCAL_RANK`` a rank takes ``cuda:(rank % device_count)``,
    and the backend comes from every rank's (host, device), exchanged before
    the group forms, whatever the coordinator's address: each rank of the
    layout runs ``initialize`` in a thread, on one in-process store, with a
    non-loopback coordinator and a mocked ``device_count``."""
    for name in ("LOCAL_RANK", "TORCHELASTIC_USE_AGENT_STORE"):
        monkeypatch.delenv(name, raising=False)
    store = torch.distributed.HashStore()
    store.set_timeout(datetime.timedelta(seconds=60))
    devices, backends = {}, {}
    me = lambda: int(threading.current_thread().name)  # noqa: E731
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_gpus)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: devices.__setitem__(me(), dev))
    monkeypatch.setattr(distributed.socket, "gethostname", lambda: hosts[me()])
    monkeypatch.setattr(distributed, "_rendezvous", lambda *a: store)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda b, **kw: backends.__setitem__(kw["rank"], b))
    monkeypatch.setattr(distributed, "_HOSTS", [])
    n = len(hosts)
    threads = [threading.Thread(name=str(r), target=distributed.initialize,
                                args=("node0:29500", n, r)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert devices == {r: torch.device("cuda", r % n_gpus) for r in range(n)}
    assert backends == {r: backend for r in range(n)}
    assert capsys.readouterr().err.count(f"backend {backend} (") == n
    assert distributed._HOSTS == hosts


def test_initialize_takes_local_rank_and_refuses_nccl_on_a_shared_gpu(monkeypatch):
    store = torch.distributed.HashStore()
    chosen = []
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(distributed, "_rendezvous", lambda *a: store)
    monkeypatch.setattr(distributed.dist, "init_process_group", lambda b, **kw: chosen.append(b))
    monkeypatch.setattr(distributed, "_HOSTS", [])
    distributed.initialize("node0:29500", 1, 0)
    assert chosen == [torch.device("cuda", 3), "nccl"]
    assert distributed.choose_backend([("a", "cuda:0"), ("a", "cuda:0")])[0] == "gloo"
    assert distributed.choose_backend([("a", "cuda:0"), ("b", "cuda:0")])[0] == "nccl"
    assert distributed.choose_backend([("a", "cpu"), ("b", "cpu")])[0] == "gloo"
    store2 = torch.distributed.HashStore()
    store2.set(distributed._PLACE_KEY + "1", "node0\0cuda:0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(distributed.socket, "gethostname", lambda: "node0")
    monkeypatch.setattr(distributed, "_rendezvous", lambda *a: store2)
    with pytest.raises(ValueError, match="backend nccl needs one GPU a rank"):
        distributed.initialize("node0:29500", 2, 0, backend="nccl")
