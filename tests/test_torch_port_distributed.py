"""The port's sharded pipeline across two OS processes joined by gloo.

The one-process meshes are covered by tests/test_torch_port_sharding.py.
This test starts two processes in one `torch.distributed` gloo group (the
port's counterpart of tests/test_distributed.py, with gloo where a cluster
of GPUs would use NCCL): frames sharded over both processes, and rows
sharded over both, with the blur's halo rows and the all-reduced maxima and
extrema crossing between them. Each worker asserts bit-equality with the
port's unsharded run; see tests/torch_distributed_worker.py. The group
meets through a file under the test's own temporary directory
(`file://` rendezvous), so no TCP port is picked and none can be taken by
another test in between.
"""
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def test_two_process_gloo_pipeline(tmp_path):
    rendezvous = tmp_path / "gloo_rendezvous"
    procs, outs = [], []
    for rank in range(2):
        out_file = tmp_path / f"worker{rank}.ok"
        outs.append(out_file)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(_HERE, "torch_distributed_worker.py"),
             str(rank), "2", str(rendezvous), str(out_file)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=120)
            logs.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out_file) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed (rc={p.returncode}):\n{logs[rank]}"
        assert out_file.read_text() == "OK", f"worker {rank}:\n{logs[rank]}"
