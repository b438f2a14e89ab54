"""The port's multi-process launch (metacache_tpu_torch/parallel/
distributed.py): two or four processes on the CPU over gloo, started with
the MC_* variables, as MPI users test with `mpirun -np P` on one box.

`build` on rank r writes the shards s % P == r, and they equal a
single-process build's with the same shard count, array for array (with
-remove-overpopulated-features too, whose counts are all-gathered).
`query -mesh` serves each rank's shards, merges candidates across the
ranks, and rank 0's result file equals the JAX CLI's single-process query
byte for byte ('# time:' / '# speed:' aside). Each process has a time
limit; past it both are killed and the test fails."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from metacache_tpu_torch.parallel.distributed import choose_backend
from tests import util_mockdata as mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra=None):
    return dict(os.environ, METACACHE_PLATFORM="cpu", PYTHONPATH=REPO,
                OMP_NUM_THREADS="1", **(extra or {}))


def cli(module, args, cwd):
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=cwd,
                       env=_env(), capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def launch_ranks(args, cwd, ranks):
    """Run the port's CLI as ranks 0..ranks-1 of one process group; fail
    (after killing all) if one exceeds the time limit or fails."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metacache_tpu_torch.cli"] + args, cwd=cwd,
        env=_env({"MC_COORDINATOR": f"127.0.0.1:{port}",
                  "MC_NUM_PROCS": str(ranks), "MC_PROC_ID": str(r)}),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{ranks}-process {args[0]} exceeded {TIMEOUT} s")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "backend gloo" in err
    return outs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torchdist"))
    fasta, _, _, _, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=6, genome_len=3000, seed=51)
    rng = np.random.default_rng(52)
    recs = [(f"NC_{10 * i + v:06d}.1|taxid|{taxids[i]}| v{v}",
             g if v == 0 else mock.mutate(rng, g, 0.01))
            for i, g in enumerate(genomes) for v in range(2)]
    mock.write_fasta(fasta, recs)
    reads = []
    for q in range(150):
        t = int(rng.integers(0, len(recs)))
        pos = int(rng.integers(0, 2800))
        reads.append((f"r{q}_NC_{t:06d}.1",
                      mock.mutate(rng, recs[t][1][pos:pos + 120], 0.01)))
    mock.write_fasta(os.path.join(tmp, "reads.fa"), reads)
    return tmp


def _npz(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def _result_lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith(("# time:", "# speed:"))]


@pytest.mark.parametrize("ranks,flags,shards", [
    pytest.param(2, [], 2, id="2-ranks-2-shards"),
    pytest.param(2, ["-num-shards", "4"], 4, id="2-ranks-4-shards"),
    pytest.param(2, ["-num-shards", "4", "-remove-overpopulated-features",
                     "-max-locations-per-feature", "1"], 4,
                 id="2-ranks-4-shards-overpopulated"),
    pytest.param(4, ["-num-shards", "6"], 6, id="4-ranks-6-shards"),
])
def test_multi_process_build_and_mesh_query(world, ranks, flags, shards):
    tag = f"d{ranks}_{len(flags)}"
    build = ["genomes.fa", "-taxonomy", "tax", "-device", "cpu"] + flags
    launch_ranks(["build", tag] + build, world, ranks)
    cli("metacache_tpu_torch.cli",
        ["build", tag + "_one"] + build + ["-num-shards", str(shards)], world)
    for s in range(shards):
        want = _npz(os.path.join(world, f"{tag}_one_{s}.npz"))
        got = _npz(os.path.join(world, f"{tag}_{s}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not os.path.exists(os.path.join(world, f"{tag}_{shards}.npz"))

    query = ["reads.fa", "-lowest", "species", "-tophits"]
    outs = launch_ranks(["query", tag] + query
                        + ["-mesh", "-device", "cpu", "-out", tag + ".txt"],
                        world, ranks)
    last = shards - 1
    assert f"shard {last} on cpu" in outs[last % ranks][1]
    cli("metacache_tpu.cli", ["query", tag] + query + ["-out", tag + "_j.txt"],
        world)
    want = _result_lines(os.path.join(world, tag + "_j.txt"))
    assert sum(not ln.startswith("#") for ln in want) == 150
    assert _result_lines(os.path.join(world, tag + ".txt")) == want


@pytest.mark.parametrize("device,world_size,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cpu", 2, 4, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 2, 2, "nccl"), ("cuda", 4, 8, "nccl"), ("cuda", 2, 0, "gloo")])
def test_backend_rule(device, world_size, cards, backend):
    assert choose_backend(device, world_size, cards) == backend
