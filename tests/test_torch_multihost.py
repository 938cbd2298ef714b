"""The port's multi-host runtime (frosting_tpu_torch.parallel.multihost):
the placement policy against the JAX package's on tests/test_multihost.py's
fake pods, initialize a no-op in one process, both command lines calling it
first, and a world of one gloo rank on the CPU, where every collective is
the identity."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from frosting_tpu.parallel import multihost as jax_multihost
from frosting_tpu_torch import cli, stages_cli
from frosting_tpu_torch.parallel import collectives, multihost
from frosting_tpu_torch.parallel import sharded_train as st
from tests.test_multihost import fake_pod

torch.set_num_threads(1)


@pytest.mark.parametrize("hosts,per_host,n_data,n_tile",
                         [(2, 4, 4, 2), (2, 4, 2, 4), (2, 3, 3, 2), (4, 2, 2, 4), (1, 8, 2, 4)])
def test_placement_matches_jax(hosts, per_host, n_data, n_tile):
    devs = fake_pod(hosts, per_host)
    got = multihost.arrange_devices(devs, n_data, n_tile)
    want = jax_multihost.arrange_devices(devs, n_data, n_tile)
    assert got.shape == want.shape == (n_data, n_tile)
    assert [d.id for d in got.ravel()] == [d.id for d in want.ravel()]
    local = all(len({d.process_index for d in row}) == 1 for row in want)
    assert multihost.tile_rows_are_local(got) == local
    with pytest.raises(ValueError):
        multihost.arrange_devices(devs, n_data + 8, n_tile)


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized()


class _Called(Exception):
    pass


@pytest.mark.parametrize("main,argv", [
    (cli.main, ["-s", "no-such-scene", "--device", "cpu"]),
    (stages_cli.main, ["render", "-s", "no-such-scene", "--device", "cpu"]),
    (stages_cli.main, ["train-gs", "-s", "no-such-scene"]),
], ids=["cli", "stages_cli-render", "stages_cli-train-gs"])
def test_command_lines_call_initialize_first(monkeypatch, main, argv):
    """initialize runs before the scene is read (a missing scene would raise
    otherwise), with the command's device."""
    seen = []

    def record(backend=None, device="cuda", timeout_s=0.0):
        seen.append(device)
        raise _Called

    monkeypatch.setattr(multihost, "initialize", record)
    with pytest.raises(_Called):
        main(argv)
    assert seen == ["cuda" if "--device" not in argv else "cpu"]


def test_a_world_of_one_gloo_rank():
    """The mesh and the collectives in a world of one: each is the identity,
    and the gradient of each is the cotangent."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    collectives.init_process_group("gloo", 0, 1, f"tcp://127.0.0.1:{port}", 30.0,
                                   device="cpu")
    try:
        mesh = multihost.make_hybrid_mesh(1, 1, device="cpu")
        assert mesh.shape == {"data": 1, "tile": 1} and multihost.tile_rows_are_local(mesh)
        assert (mesh.data_index, mesh.tile_index, mesh.flat_index) == (0, 0, 0)
        x = torch.arange(12.0).reshape(4, 3).requires_grad_(True)
        outs = [collectives.all_gather(x, mesh, "tile"), collectives.psum(x, mesh, st.WORLD),
                collectives.ppermute(x, mesh, "tile", 1),
                collectives.all_to_all(x, mesh, "data")]
        for y in outs:
            assert torch.equal(y, x)
        g = torch.autograd.grad(sum((y * (i + 1)).sum() for i, y in enumerate(outs)), x)[0]
        assert torch.equal(g, torch.full_like(x, 10.0))
        assert torch.equal(collectives.pmax(x, mesh, st.WORLD), x.detach())
        # all_to_all's bytes: its call and its backward's
        assert mesh.stats["all_gather_calls"] == 1 and mesh.stats["all_to_all_bytes"] == 2 * 48
        assert np.array_equal(st.shard_rows(x.detach(), mesh).numpy(), x.detach().numpy())
    finally:
        dist.destroy_process_group()
