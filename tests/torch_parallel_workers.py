"""Functions the spawned ranks of tests/test_torch_parallel.py and
tests/test_torch_mapping.py run. A module of its own, importing torch and
the port only, so that a child process can import it without importing
JAX."""

import numpy as np
import torch

from stereo_svo_tpu_torch.parallel import dist_ba, mapping
from stereo_svo_tpu_torch.parallel import mesh as mesh_mod


def reduce_leaves_argument(rank: int, n: int):
    """``reduce_fn`` returns the sum over the ranks and leaves its
    argument as it was, for a contiguous and a strided tensor."""
    reduce_fn = dist_ba.all_reduce_sum(mesh_mod.make(n, "kf").group("kf"))
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1)
    for x in (base, base.T, base[:, ::2]):
        before = x.clone()
        y = reduce_fn(x)
        assert torch.equal(x, before)
        assert y.data_ptr() != x.data_ptr()
        assert torch.equal(y, before / (rank + 1) * sum(range(1, n + 1)))
    return True


def mesh_2d_coordinates(rank: int, n: int, n_data: int, n_kf: int):
    """A (data, kf) mesh: this rank's coordinates, and a sum over each
    axis of 10^rank, which names the ranks that took part."""
    mesh = mesh_mod.make_2d(n_data, n_kf)
    sums = {}
    for axis in ("data", "kf"):
        sums[axis] = float(dist_ba.all_reduce_sum(mesh.group(axis))(
            torch.tensor(10.0 ** rank, dtype=torch.float64)))
    outside = mesh_mod.make(n - 1, "kf")        # the last rank is outside
    return (mesh.index("data"), mesh.index("kf"), sums,
            outside.groups["kf"] is None)


def hang(rank: int, n: int):
    import time
    time.sleep(600)


def fail_on_rank_one(rank: int, n: int):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def backend_and_device(rank: int, n: int):
    """The default group's backend and where this rank's tensors go."""
    import torch.distributed as dist
    return dist.get_backend(), str(mesh_mod.rank_device())


def optimize_map(rank: int, n: int, cam, cfg, gmap_np: dict):
    """``mapping.optimize_global_map`` on a whole map given as numpy, on
    this rank's device."""
    device = mesh_mod.rank_device()
    gmap = mapping.GlobalMap(**{k: torch.from_numpy(np.array(v)).to(device)
                                for k, v in gmap_np.items()})
    refined, pg_cost = mapping.optimize_global_map(
        mesh_mod.make(n, "kf"), cam, cfg, gmap)
    return (refined.kf_T_wk.cpu().numpy(), refined.X.cpu().numpy(),
            float(pg_cost))
