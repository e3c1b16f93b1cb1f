"""The port's own build of the native host library, on the CPU.

hiphase_tpu_torch/csrc/hiphase_native.cc is native/hiphase_native.cc
verbatim outside its two BGZF-codec regions and the region that includes
the WFA graph builder, csrc/wfa_build.h, whose builder is the original's
line for line; `build_host_library` compiles
it with libdeflate, zlib or no codec. Each build must name its codec, write
BGZF that Python's gzip reads back exactly and read the committed
library's BGZF; the zlib build must phase exactly as the committed library
and the host A* oracle do; and the loader must try the committed library
first, then the port's build, and neither under HIPHASE_TPU_NO_NATIVE.
Beside either, the loader builds and binds the port's own library (the A*
oracle's heuristic sweep, csrc/astar_sweep.cc, the device WFA's pass 1,
csrc/wfa_windows.cc, and its window packer, csrc/wfa_pack.cc, in one),
reused by the hash of its inputs, or leaves every Python path with one
warning.
"""

import gzip
import logging
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from hiphase_tpu_torch import cli
from hiphase_tpu_torch.core.variants import Variant
from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.kernels import build
from hiphase_tpu_torch.phasing import astar
from hiphase_tpu_torch.phasing.global_realign import WfaBlockPack
from hiphase_tpu_torch.utils import golden

from tests.sim import build_dataset

REPO = pathlib.Path(__file__).resolve().parent.parent
BEGIN = "// ---- BGZF codec (hiphase_tpu_torch): begin ----"
END = "// ---- BGZF codec (hiphase_tpu_torch): end ----"
WFA_BEGIN = "// ---- WFA graph builder (hiphase_tpu_torch): begin ----"
WFA_END = "// ---- WFA graph builder (hiphase_tpu_torch): end ----"


@pytest.fixture(scope="module")
def libraries():
    """Every codec's build, compiled concurrently (or found in the cache)."""
    with ThreadPoolExecutor(len(build.CODECS)) as pool:
        return dict(zip(build.CODECS,
                        pool.map(build.build_host_library, build.CODECS)))


def _use(monkeypatch, lib):
    """Bind io/native.py to ``lib`` (None: no native library)."""
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(native, "_TRIED", True)


def _payloads():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 4, size=n).astype(np.uint8).tobytes()
            for n in (0, 1, 1000, 65536, 30000, 4096)]


def _outside_regions(lines):
    """The runs of lines outside the codec regions, in order."""
    runs, run, inside = [], [], False
    for line in lines:
        if line in (BEGIN, END):
            assert inside == (line == END), line
            inside = not inside
            if inside:
                runs.append(run)
                run = []
        elif not inside:
            run.append(line)
    assert not inside
    return runs + [run]


def _with_builder(port):
    """The port's source with its builder region replaced by the builder
    that csrc/wfa_build.h holds between its markers."""
    header = build.WFA_BUILD_HEADER.read_text().split("\n")
    builder = header[header.index("// ---- hn_wfa_build: begin ----") + 1:
                     header.index("// ---- hn_wfa_build: end ----")]
    lo, hi = port.index(WFA_BEGIN), port.index(WFA_END)
    assert port[lo + 1:hi] == ['#include "wfa_build.h"']
    assert any(line.startswith("int64_t hn_wfa_build(") for line in builder)
    return port[:lo] + builder + port[hi + 1:]


def test_source_equals_native_outside_codec_markers():
    port = _with_builder(build.HOST_SOURCE.read_text().split("\n"))
    orig = (REPO / "native" / "hiphase_native.cc").read_text().split("\n")
    head, middle, tail = _outside_regions(port)
    # the original is head + (region) + middle + (region) + tail, line for
    # line
    assert orig[:len(head)] == head
    assert orig[len(orig) - len(tail):] == tail
    at = [k for k in range(len(head), len(orig) - len(tail) - len(middle))
          if orig[k:k + len(middle)] == middle]
    assert len(at) == 1
    # the regions replace the codec includes and the two codec functions
    assert orig[len(head):at[0]] == ["#include <zlib.h>",
                                     "#include <libdeflate.h>"]
    body = orig[at[0] + len(middle):len(orig) - len(tail)]
    assert body[0].startswith("int64_t hn_bgzf_compress_many(")
    assert body[-1] == "}"
    assert "int32_t hn_bgzf_decompress_many(" in "\n".join(body)
    assert not any(line.startswith("int64_t hn_bgzf_scan(") for line in body)


@pytest.mark.parametrize("codec", list(build.CODECS))
def test_build_names_its_codec(libraries, codec):
    built = libraries[codec]
    assert built.codec == codec
    assert built.library == build.host_library_path(codec)
    assert built.library.parent == build.BUILD_DIR
    assert native.codec_of(native.bind(built.library)) == codec


def test_library_names_differ_by_codec_and_source(tmp_path, monkeypatch):
    paths = {build.host_library_path(c) for c in build.CODECS}
    assert len(paths) == len(build.CODECS)
    edited = tmp_path / "hiphase_native.cc"
    edited.write_text(build.HOST_SOURCE.read_text() + "\n// edited\n")
    before = build.host_library_path("zlib")
    monkeypatch.setattr(build, "HOST_SOURCE", edited)
    assert build.host_library_path("zlib") != before


def test_auto_takes_the_header_the_compiler_finds(libraries):
    want = build.header_codec(build.cxx())
    assert build.build_host_library().codec == want


@pytest.mark.parametrize("codec", list(build.CODECS))
def test_bgzf_round_trip(libraries, codec, monkeypatch):
    payloads = _payloads()
    _use(monkeypatch, native.bind(native.COMMITTED_PATH))
    committed_bgzf = native.bgzf_compress_blocks(payloads)
    assert gzip.decompress(committed_bgzf) == b"".join(payloads)

    _use(monkeypatch, native.bind(libraries[codec].library))
    blob = native.bgzf_compress_blocks(payloads, threads=3)
    from_committed = native.bgzf_decompress_all(committed_bgzf)
    if codec == "none":
        # no codec: both functions fail, and their callers use Python's zlib
        assert blob is None and from_committed is None
        return
    assert gzip.decompress(blob) == b"".join(payloads)
    assert native.bgzf_decompress_all(blob) == b"".join(payloads)
    assert from_committed == gzip.decompress(committed_bgzf)


def test_compiler_error_carries_its_output(tmp_path, monkeypatch):
    bad = tmp_path / "hiphase_native.cc"
    bad.write_text("int broken = ;\n")
    monkeypatch.setattr(build, "HOST_SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelBuildError, match="broken") as err:
        build.build_host_library("none")
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def _phase(tmp_path, data, name, engine):
    fasta, vcf, bam = data
    out = [str(tmp_path / f"{name}.{x}") for x in ("vcf.gz", "bam", "tsv")]
    assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", out[0], "--output-bam", out[1],
                     "--blocks-file", out[2], "--engine", engine,
                     "--threads", "2"]) == 0
    assert cli.LAST_RUN_STATS["engine"] == engine
    return golden.normalize(*out)


def test_cli_native_engine_on_the_zlib_build(libraries, tmp_path,
                                             monkeypatch):
    fasta, vcf, bam, _c, _ = build_dataset(tmp_path, seed=41, n_contigs=2,
                                           contig_len=6000, coverage=12)
    data = (fasta, vcf, bam)
    _use(monkeypatch, native.bind(native.COMMITTED_PATH))
    committed = _phase(tmp_path, data, "committed", "native")
    _use(monkeypatch, native.bind(libraries["zlib"].library))
    zlib_run = _phase(tmp_path, data, "zlib", "native")
    # the zlib build read the input and wrote the output itself
    with open(bam, "rb") as fh:
        assert native.bgzf_decompress_all_arr(fh.read()) is not None
    _use(monkeypatch, native.bind(native.COMMITTED_PATH))
    astar = _phase(tmp_path, data, "astar", "astar")
    assert zlib_run["vcf"] and zlib_run["bam"] and zlib_run["blocks"]
    assert zlib_run == committed
    assert zlib_run == astar


@pytest.fixture
def fresh_loader(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_PORT", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "LOADED", {})
    monkeypatch.setattr(native, "PORT_LOADED", {})
    monkeypatch.delenv("HIPHASE_TPU_NO_NATIVE", raising=False)


def _sweep_path():
    """Which path `astar.calculate_astar_heuristic` takes on a small
    block: "native" or "python"."""
    from hiphase_tpu_torch.core.read_segments import ReadSegment
    reads = [ReadSegment.new(f"r{i}", [i % 2, 1, 0, (i + 1) % 2],
                             [20, 30, 25, 40]) for i in range(6)]
    astar.take_sweep_counts()
    astar.calculate_astar_heuristic(4, astar.MAX_SEGMENT_SIZE,
                                    astar._BlockReads(reads, 4), 1000, 3,
                                    None)
    counts = astar.take_sweep_counts()
    assert sum(counts.values()) == 1
    return max(counts, key=counts.get)


def _pack_path():
    """Which path the device WFA's window packer takes on a small block:
    "native" (`native.wfa_pack_sizes` sizes the window) or "python"."""
    ref = b"ACGGT" * 60
    hets = [Variant.new_snv(i, p, ref[p:p + 1], b"T", 0, 1)
            for i, p in enumerate((40, 92, 151))]
    rows = native.wfa_pack_sizes(WfaBlockPack(hets, []), ref, [30], [200],
                                 np.frombuffer(ref[30:200], np.uint8),
                                 [0, 170])
    if rows is None:
        return "python"
    assert rows[0, 0] == 1
    return "native"


def _windows_path():
    """Which path the device WFA's pass 1 takes on one record: "native"
    (`native.wfa_windows` finds its window) or "python"."""
    from hiphase_tpu_torch.utils.simulate import make_read_raw
    raw = make_read_raw(b"r", 0, 100, np.frombuffer(b"ACGTA" * 40, np.uint8),
                        [("S", 5), ("M", 195)], 30, 0, b"")
    out = native.wfa_windows([(np.frombuffer(raw, np.uint8), np.array([0]),
                               np.array([len(raw)]))], np.array([150]))
    if out is None:
        return "python"
    assert out[0].tolist() == [True] and (out[1][0], out[2][0]) == (100, 295)
    return "native"


PATHS = {"sweep": _sweep_path, "pack": _pack_path, "windows": _windows_path}
# what the warning says of each Python path
FALLBACK = {"sweep": "the estimated-cost sweep runs in Python",
            "pack": "windows are built and linearised in Python",
            "windows": "pass 1 finds each read's window in Python"}


@pytest.mark.parametrize("twin", ["sweep", "pack", "windows"])
@pytest.mark.parametrize("host", ["committed", "built"])
def test_loader_binds_the_port_library_with_the_host_library(
        libraries, fresh_loader, tmp_path, monkeypatch, host, twin):
    if host == "built":
        monkeypatch.setattr(native, "COMMITTED_PATH",
                            str(tmp_path / "none.so"))
    assert native.available()
    assert native.LOADED["origin"] == host
    assert native.port_available()
    assert native.PORT_LOADED["path"] == str(build.port_library_path())
    assert PATHS[twin]() == "native"


@pytest.mark.parametrize("twin", ["sweep", "pack", "windows"])
def test_failed_port_build_leaves_the_python_paths_with_one_warning(
        fresh_loader, monkeypatch, caplog, twin):
    def refuse(*_a, **_kw):
        raise build.KernelBuildError("g++: error: the port's twins said no")
    monkeypatch.setattr(build, "build_port_library", refuse)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.available()
        assert not native.port_available()
        assert not native.port_available()
        assert PATHS[twin]() == "python"
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1
    assert "the port's twins said no" in warnings[0].getMessage()
    assert FALLBACK[twin] in warnings[0].getMessage()
    assert native.PORT_LOADED["path"] is None


@pytest.mark.parametrize("edited", ["astar_sweep.cc", "wfa_windows.cc",
                                    "wfa_pack.cc", "wfa_build.h"])
def test_port_library_is_reused_by_hash(tmp_path, monkeypatch, edited):
    """The port's library builds once into the build directory and is found
    by the hash of its sources and of the graph builder's header: an edit
    to any of them moves its name, and one to the header, which the host
    library includes too, also the host library's."""
    built = build.build_port_library()
    assert built.library == build.port_library_path()
    assert built.library.parent == build.BUILD_DIR and built.library.exists()
    assert built.library.name.startswith("libhiphase_port_")
    again = build.build_port_library()
    assert again.library == built.library and again.seconds == 0.0
    copy = tmp_path / edited
    copy.write_text((build.CSRC / edited).read_text() + "\n// edited\n")
    host = build.host_library_path("zlib")
    if edited == "wfa_build.h":
        monkeypatch.setattr(build, "WFA_BUILD_HEADER", copy)
    else:
        monkeypatch.setattr(build, "PORT_SOURCES", tuple(
            copy if p.name == edited else p for p in build.PORT_SOURCES))
    assert build.port_library_path() != built.library
    assert (build.host_library_path("zlib") != host) == (
        edited == "wfa_build.h")


def test_loader_takes_the_committed_library_first(fresh_loader,
                                                  monkeypatch):
    def no_build(*_a, **_kw):
        raise AssertionError("built although the committed library loads")
    monkeypatch.setattr(build, "build_host_library", no_build)
    assert native.available()
    assert native.LOADED == {"origin": "committed",
                             "path": native.COMMITTED_PATH,
                             "codec": "libdeflate", "build_seconds": 0.0}


@pytest.mark.parametrize("committed", ["missing", "not a library"])
def test_loader_builds_when_the_committed_library_fails(
        libraries, fresh_loader, tmp_path, monkeypatch, committed):
    path = tmp_path / "libhiphase_native.so"
    if committed == "not a library":
        path.write_bytes(b"\x7fELF not really")
    monkeypatch.setattr(native, "COMMITTED_PATH", str(path))
    assert native.available()
    want = build.build_host_library()
    assert native.LOADED["origin"] == "built"
    assert native.LOADED["path"] == str(want.library)
    assert native.LOADED["codec"] == want.codec


def test_failed_build_leaves_pure_python_with_one_warning(
        fresh_loader, tmp_path, monkeypatch, caplog):
    def refuse(*_a, **_kw):
        raise build.KernelBuildError("g++: error: compiler said no")
    monkeypatch.setattr(native, "COMMITTED_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(build, "build_host_library", refuse)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
        assert not native.available()
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1
    assert "compiler said no" in warnings[0].getMessage()
    assert native.bgzf_compress_blocks(_payloads()) is None


def test_no_native_disables_both_libraries(fresh_loader, monkeypatch):
    def no_build(*_a, **_kw):
        raise AssertionError("built under HIPHASE_TPU_NO_NATIVE")
    monkeypatch.setattr(build, "build_host_library", no_build)
    monkeypatch.setattr(build, "build_port_library", no_build)
    monkeypatch.setenv("HIPHASE_TPU_NO_NATIVE", "1")
    assert not native.available()
    assert native.LOADED["origin"] is None
    assert not native.port_available()
    assert native._PORT is None
    assert native.PORT_LOADED["path"] is None
    assert _sweep_path() == "python"
    assert _pack_path() == "python"
