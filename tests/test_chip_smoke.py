"""chip_smoke.py and the pieces it rests on, at a tiny size on the CPU:
seeded data, the device check, the result line, the compile-cache
location, the CLI's refusal of a silent CPU fallback, and every smoke
phase end to end."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from pseudoaligner_tpu import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_generators_are_deterministic():
    a = synth.transcriptome(n_tx=50, seed=7)
    b = synth.transcriptome(n_tx=50, seed=7)
    assert a[1] == b[1] and a[2] == b[2]
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert not np.array_equal(synth.transcriptome(n_tx=50, seed=8)[0][0],
                              a[0][0])
    seqs = a[0]
    assert np.array_equal(synth.reads(seqs, 99, 60, seed=1),
                          synth.reads(seqs, 99, 60, seed=1))
    p, q = synth.pairs(seqs, 30, 60, seed=2), synth.pairs(seqs, 30, 60, seed=2)
    assert all(np.array_equal(x, y) for x, y in zip(p, q))
    r1, r2, cells = synth.count_inputs(seqs, 200, 10, r2_len=91, seed=3)
    assert r1.shape == (200, 28) and r2.shape == (200, 91)
    wl = synth.whitelist(cells, 100)
    assert len(wl) == len(set(wl)) == 100
    assert {synth.ACGT[c].tobytes().decode() for c in cells} <= set(wl)


def test_read_recipe_kinds():
    """Exact windows, one-substitution windows and reversed windows,
    interleaved: every kind is where the recipe says."""
    seqs = synth.transcriptome(n_tx=30, seed=1)[0]
    txt = [s.tobytes() for s in seqs]
    reads = synth.reads(seqs, 30, 60, seed=4)
    for i, r in enumerate(reads):
        fwd = any(r.tobytes() in t for t in txt)
        rev = any(r[::-1].tobytes() in t for t in txt)
        if i % 3 == 0:
            assert fwd
        elif i % 3 == 1:
            assert not fwd  # the substitution breaks the exact window
        else:
            assert rev


def test_gencode_header_round_trip(tmp_path):
    from pseudoaligner_tpu.config import FastaFormat
    from pseudoaligner_tpu.io.fasta import (
        detect_fasta_format, iter_fasta, read_transcripts)

    seqs, names, gene_map = synth.transcriptome(n_tx=40, seed=3)
    fa = str(tmp_path / "t.fa")
    synth.write_fasta(fa, seqs, names, gene_map)
    rec = next(iter_fasta(fa))
    assert detect_fasta_format(rec) == FastaFormat.GENCODE
    got_seqs, got_names, got_map = read_transcripts(fa)
    assert got_names == names and got_map == gene_map
    assert all(np.array_equal(x, y) for x, y in zip(got_seqs, seqs))


def test_write_bundled_shape(tmp_path):
    from pseudoaligner_tpu.io.fastq import read_fastq_records

    fa, fq = synth.write_bundled(str(tmp_path), n_tx=25, n_reads=40)
    assert sum(1 for line in open(fa) if line.startswith(">")) == 25
    recs = list(read_fastq_records(fq))
    assert len(recs) == 40
    assert {len(s) for _, s in recs} == {synth.BUNDLED["read_len"]}


def test_check_device():
    chip_smoke.check_device("gpu")
    for platform in ("cpu", "tpu"):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            chip_smoke.check_device(platform)


def test_result_line():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "extra": 3})
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/cache"])
def test_compile_cache_location(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory;
    otherwise the fixed <repo>/.jax_cache.  Nothing on the CPU."""
    import jax

    from pseudoaligner_tpu import jaxcache

    if env_dir is None:
        monkeypatch.delenv(jaxcache.ENV, raising=False)
    else:
        monkeypatch.setenv(jaxcache.ENV, env_dir)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert jaxcache.enable_compilation_cache("cpu") is None
    assert calls == []
    got = jaxcache.enable_compilation_cache("gpu")
    dirs = [v for k, v in calls if k == "jax_compilation_cache_dir"]
    if env_dir is None:
        assert got == jaxcache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
        assert dirs == [jaxcache.DEFAULT_DIR]
    else:
        assert got == env_dir and dirs == []


def test_check_platform():
    from pseudoaligner_tpu.backend import check_platform

    check_platform("gpu", cpu_ok=False)
    check_platform("cpu", cpu_ok=True)
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        check_platform("cpu", cpu_ok=False)


def test_cli_refuses_implicit_cpu_fallback(tmp_path):
    """A device subcommand on a JAX that fell back to the CPU stops with
    the hint; with JAX_PLATFORMS=cpu it runs."""
    fa, _ = synth.write_bundled(str(tmp_path), n_tx=10, n_reads=5)
    env = dict(os.environ, PYTHONPATH=REPO, PSEUDOALIGNER_LOG="WARNING",
               CUDA_VISIBLE_DEVICES="")
    idx = str(tmp_path / "i.idx")

    def run(*args, **extra):
        return subprocess.run(
            [sys.executable, "-m", "pseudoaligner_tpu", *args],
            capture_output=True, text=True, env=dict(env, **extra),
            timeout=300)

    assert run("index", "-i", idx, fa, JAX_PLATFORMS="cpu").returncode == 0
    implicit = dict(env)
    implicit.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-m", "pseudoaligner_tpu", "mappability", "-i",
         idx, "-o", str(tmp_path / "m")],
        capture_output=True, text=True, env=implicit, timeout=300)
    assert r.returncode == 1
    assert "JAX_PLATFORMS=cpu" in r.stderr
    assert not (tmp_path / "m" / "tx_mappability.tsv").exists()
    r = run("mappability", "-i", idx, "-o", str(tmp_path / "m"),
            JAX_PLATFORMS="cpu")
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "m" / "tx_mappability.tsv").exists()


def test_native_key_follows_host_cpu(monkeypatch, tmp_path):
    """A library built on another host (other CPU flags) has another
    key, so it is never loaded here."""
    from pseudoaligner_tpu import _nativebuild

    src = tmp_path / "x.cpp"
    src.write_text("int f() { return 1; }\n")
    here = _nativebuild.artifact_key(str(src))
    assert here == _nativebuild.artifact_key(str(src))
    assert here != _nativebuild.artifact_key(str(src), ("-lz",))
    monkeypatch.setattr(_nativebuild, "host_cpu", lambda: "other:avx512f")
    assert _nativebuild.artifact_key(str(src)) != here
    monkeypatch.undo()
    src.write_text("int f() { return 2; }\n")
    assert _nativebuild.artifact_key(str(src)) != here


def test_smoke_phases_tiny(tmp_path, capsys):
    """Every single-card phase end to end on the CPU at a tiny size,
    with the golden comparison."""
    opts = chip_smoke.parse_args([
        "--novel-mb", "0.1", "--reads", "600", "--pairs", "200",
        "--count-pairs", "600", "--cells", "12", "--whitelist", "300",
        "--oracle-reads", "150", "--oracle-pairs", "60",
        "--bundled-tx", "40", "--bundled-reads", "150",
        "--batch-size", "256", "--workdir", str(tmp_path)])
    chip_smoke.Smoke(opts, card="cpu").single()
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    phases = {o["phase"]: o for o in out}
    assert list(phases) == ["index", "map", "paired", "count", "oracle",
                            "mappability"]
    assert phases["map"]["reads"] == 600
    assert phases["paired"]["pairs"] == 200
    assert phases["oracle"]["sample_mismatches"] == 0
    assert phases["oracle"]["bundled_mismatches"] == 0
    assert phases["mappability"]["transcripts"] == 40


def test_smoke_multi_tiny(tmp_path, capsys):
    """The four-card path on four virtual CPU devices at a tiny size:
    kpart (native and device re-map), its exact pass and the replicated
    engine all agree with one device."""
    opts = chip_smoke.parse_args([
        "--devices", "4", "--novel-mb", "0.05", "--batch-size", "256",
        "--workdir", str(tmp_path)])
    chip_smoke.Smoke(opts, card="cpu").multi(4)
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    multi = out[-1]
    assert multi["phase"] == "multi" and multi["reads"] == 4 * 256
    for key in ("kpart_identical", "kpart_device_remap_identical",
                "kpart_exact_identical", "replicated_identical"):
        assert multi[key] is True, key
    assert multi["kpart_exact_reads"] == 256


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu")


@pytest.mark.gpu
def test_smoke_on_gpu(gpu, tmp_path, capsys):
    rc = chip_smoke.main([
        "--novel-mb", "1", "--reads", "20000", "--pairs", "5000",
        "--count-pairs", "5000", "--cells", "50", "--whitelist", "1000",
        "--oracle-reads", "500", "--oracle-pairs", "200",
        "--workdir", str(tmp_path)])
    assert rc == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert json.loads(last)["device"]["platform"] == "gpu"
