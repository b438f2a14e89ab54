"""`-mesh` over more shards than devices: the port against the JAX CLI.

The port places every shard on the one device and queries them sharded,
so each shard truncates its match list at -max-locations-per-query on
its own, as the reference's per-rank shards do. The JAX CLI given one
device runs `-mesh` fused instead (it needs one device per shard,
metacache_tpu/modes/query.py:820). On a world whose paired reads
overflow 64 match slots, in 2 shards:
  * the port's `-mesh -device cpu` equals the JAX CLI's `-mesh` on 2
    forced host devices, line for line;
  * it differs from the JAX CLI's one-device `-mesh` (the fused lines)
    only on reads whose fused match list overflows: a read that loses no
    location to the fused cut keeps its fused line.
This pins a kept difference of the port, as
tests/test_torch_ops.py::test_target_window_hits_on_full_rows pins the
JAX over-count: the port is right by the reference's per-rank model."""
import os

import numpy as np

from tests.test_torch_cli import _result_lines, port_cli, run, world  # noqa: F401

LMAX = "64"
#: -tophits prints each read's best targets with their hit counts, which a
#: truncated match list changes even where the species stays the same
FLAGS = ["-pairfiles", "-lowest", "species", "-tophits",
         "-max-locations-per-query", LMAX]
READS = ["reads_1.fa", "reads_2.fq"]


def _fused_overflow_reads(world, db):
    """Names of the reads whose fused match list overflows LMAX slots, from
    the JAX package's engine with its CLI's fused pipeline (the oracle, as
    metacache_tpu/modes/query.py:838-841 sets it up)."""
    from metacache_tpu import native
    from metacache_tpu.modes import query as q
    from metacache_tpu.query.engine import QueryEngine
    from metacache_tpu.utils import ArgsParser
    name = os.path.join(world, db)
    reads = [os.path.join(world, r) for r in READS]
    opt = q.get_query_options(ArgsParser(["query", name] + reads + FLAGS))
    fused = q.load_all_shards(name)
    q._apply_database_tuning(opt, fused)
    q._adapt_options_to_database(opt, fused)
    eng = QueryEngine(fused, opt.classify, opt.pipeline)
    over = set()
    for b in native.NativeBatchReader(reads[0], reads[1], "files",
                                      opt.pipeline.batch_size,
                                      opt.pipeline.max_query_len):
        res = eng.materialize(eng.dispatch_packed(
            b.packed1, b.ambig1, b.lens1, b.packed2, b.ambig2, b.lens2),
            b.n)
        over |= {b.headers[i].split()[0]
                 for i in np.nonzero(res.match_overflow[:b.n] > 0)[0]}
    return over


def test_mesh_on_one_device_differs_from_jax_only_on_overflow(world):  # noqa: F811
    r = port_cli(["build", "tdb2m", "genomes.fa", "-taxonomy", "tax",
                  "-num-shards", "2", "-device", "cpu"], world)
    assert r.returncode == 0, r.stderr
    base = ["query", "tdb2m"] + READS + FLAGS + ["-mesh"]
    rt = port_cli(base + ["-device", "cpu", "-out", "mesh2_port.txt"], world)
    assert rt.returncode == 0, rt.stderr
    assert "shard 1 on cpu" in rt.stderr
    r2 = run("metacache_tpu.cli", base + ["-out", "mesh2_jax2.txt"], world,
             env={"XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert r2.returncode == 0, r2.stderr
    assert "falling back" not in r2.stderr
    r1 = run("metacache_tpu.cli", base + ["-out", "mesh2_jax1.txt"], world)
    assert r1.returncode == 0, r1.stderr
    assert "falling back to fused single-device query" in r1.stderr
    port = _result_lines(os.path.join(world, "mesh2_port.txt"))
    assert port == _result_lines(os.path.join(world, "mesh2_jax2.txt"))
    fused = _result_lines(os.path.join(world, "mesh2_jax1.txt"))
    assert len(port) == len(fused) and len(port) > 240
    differ = {a.split("\t")[0] for a, b in zip(port, fused)
              if a != b and not a.startswith("#")}
    over = _fused_overflow_reads(world, "tdb2m")
    assert differ and differ <= over, (differ - over, len(over))
