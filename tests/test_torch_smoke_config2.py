"""chip_smoke.py's config2, options and modify phases rehearsed on the
CPU, on bench.py's config-2 generator cut to 200 genomes and 8,192 reads:
the build beside a header-only assembly_summary.txt and a truncated FASTQ
(both reported, neither in the database), the summaries run (-abundances,
-abundance-per, -precision, -taxon-coverage, -hits-per-seq) and the other
option runs held to the CPU CLI byte for byte, and `modify` with a
malformed file among its inputs (reported on stderr, every array equal to
the one-shot build's). The card's own calls are stubbed; the checks tied
to the uncut world are skipped by the phases themselves."""
import os

import torch


def test_config2_phases_rehearsed_on_cpu(tmp_path, monkeypatch):
    import bench
    import chip_smoke
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(bench, "C2_GENOMES", 200)
    monkeypatch.setattr(bench, "C2_READS", 8192)
    for k, v in dict(CPU_LINES=2048, ALIGN_READS=128,
                     MODIFY_ADDED=20).items():
        monkeypatch.setattr(chip_smoke, k, v)
    for name, stub in (("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, stub)
    monkeypatch.setattr(chip_smoke, "check_launched",
                        lambda path, name, n, expected=None: None)
    fractions = []
    monkeypatch.setattr(chip_smoke, "check_fraction",
                        lambda path, frac, expected=None:
                        fractions.append(frac))
    said = []
    say = chip_smoke.say
    monkeypatch.setattr(chip_smoke, "say", lambda phase, **fields: (
        said.append((phase, fields)), say(phase, **fields))[1])

    c2 = chip_smoke.phase_config2()
    built = [f for p, f in said if p == "config2" and "fail_lines" in f]
    assert built and built[0]["fail_lines"] == 2
    assert built[0]["targets"] == 200
    chip_smoke.phase_options(c2)
    summaries = [f for p, f in said if p == "summaries"]
    assert summaries and summaries[0]["reads"] == 2048
    chip_smoke.phase_modify(c2)
    modified = [f for p, f in said if p == "modify"]
    assert modified[0]["arrays_equal_oneshot"] == "yes"
    assert modified[0]["fail_lines"] == 1
    assert all(f > 0.9 for f in fractions)
    assert os.path.exists(os.path.join(str(tmp_path), "summaries_cpu.txt"))
