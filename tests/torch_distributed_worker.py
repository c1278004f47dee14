"""Worker process for the port's 2-process gloo rehearsal.

Launched by tests/test_torch_port_distributed.py as `python
torch_distributed_worker.py <rank> <world_size> <rendezvous_file>
<out_file>`. Each process joins a gloo process group that meets through
the file (`file://<rendezvous_file>`) and checks,
against the port's unsharded `stereo_pipeline` on the same frames:

  1. Frames over both processes: an 8-slot "data" mesh (4 CPU slots per
     process). Each process feeds its LOCAL 4 frames to `shard_batch`; the
     naive fill's local output is bit-equal to the unsharded run on those
     frames, the gathered output to the whole batch's, and the global mean,
     all-reduced over the two processes, matches the whole batch's mean.
  2. Rows over both processes: a (1, 2) ("data", "seq") mesh, rank r holding
     rows r*H/2 .. (r+1)*H/2 - 1 of every frame. gpu_warp with the depth
     blur (halo rows cross the processes) and a batch whose 0-1 test
     differs between the two halves (the chunk-wide max is all-reduced);
     left-right and top-bottom, bit-equal.
"""
import os
import sys


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rendezvous, out_file = sys.argv[3], sys.argv[4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
        from comfystereo_tpu_torch.parallel import sharding
        from comfystereo_tpu_torch.utils import fixtures

        h, w, b = 32, 64, 8
        img = fixtures.create_test_image(h, w).astype(np.float32) / 255.0
        dep = fixtures.create_depth_map(h, w).astype(np.float32) / 255.0
        imgs = torch.from_numpy(np.stack([np.roll(img, f, axis=1) for f in range(b)]))
        deps = torch.from_numpy(np.stack([np.roll(dep, f, axis=1) for f in range(b)]))

        # 1. frames over the processes
        cfg = StereoConfig(modes=("left-right",), fill_technique="naive")
        mesh = sharding.make_mesh(8, axes=("data",), device="cpu")
        n_local = 8 // world
        lo, hi = rank * n_local, (rank + 1) * n_local
        s_img, s_dep = sharding.shard_batch(imgs[lo:hi], deps[lo:hi], mesh)
        assert tuple(s_img.shape) == (b, h, w, 3), s_img.shape
        out = stereo_pipeline(s_img, s_dep, cfg)["stereo"][0]
        ref = stereo_pipeline(imgs[lo:hi], deps[lo:hi], cfg)["stereo"][0]
        assert torch.equal(out.local(), ref), "local frames differ"
        full = stereo_pipeline(imgs, deps, cfg)["stereo"][0]
        assert torch.equal(out.gather(), full), "gathered frames differ"
        total = out.local().double().sum().reshape(1)
        dist.all_reduce(total)
        gmean = float(total) / full.numel()
        np.testing.assert_allclose(gmean, float(full.double().mean()), rtol=1e-5)

        # 2. rows over the processes, with halos and the all-reduced max
        deps2 = deps.clone()
        deps2[:, h // 2:] *= 255.0  # only the bottom half is outside 0-1
        cfg2 = StereoConfig(modes=("left-right", "top-bottom"))
        mesh2 = sharding.make_mesh(2, axes=("data", "seq"), shape=(1, 2), device="cpu")
        rows = slice(rank * h // 2, (rank + 1) * h // 2)
        s_img2, s_dep2 = sharding.shard_batch(imgs[:, rows], deps2[:, rows], mesh2, rows=True)
        got = stereo_pipeline(s_img2, s_dep2, cfg2)
        want = stereo_pipeline(imgs, deps2, cfg2)
        for name in ("left_depth", "right_depth", "mask"):
            assert torch.equal(got[name].gather(), want[name]), name
        for g, wnt in zip(got["stereo"], want["stereo"]):
            assert torch.equal(g.gather(), wnt), "packed output differs"
        assert torch.equal(got["stereo"][0].local(), want["stereo"][0][:, rows])
    finally:
        dist.destroy_process_group()

    with open(out_file, "w") as f:
        f.write("OK")


if __name__ == "__main__":
    main()
