"""The port's kernel libraries on the CPU: what ``_build.Library`` binds
and counts, and that every packed entry point reads exactly the
arguments its wrapper packs (the C sources are parsed; nothing is
compiled here)."""
import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import kge_score as tkge
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import swa_attention as tswa
from repro_torch.kernels import topk_similarity as tts

LIBS = {"topk_cosine": tts._LIB, "kge_score": tkge._LIB,
        "swa_attention": tswa._LIB, "selective_scan": tss._LIB}
PACKED = [(src, name) for src, lib in LIBS.items() for name in lib.packers]


def _entry_body(source: str, name: str) -> str:
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf"int {name}\(const long long\* a\) \{{(.*?)\n\}}", text,
                  re.S)
    assert m, f"{name} in {source}.cu takes no packed arguments"
    return m.group(1)


@pytest.mark.parametrize("source,name", PACKED)
def test_packed_entry_reads_every_packed_argument(source, name):
    """The C entry point reads a[0] .. a[n - 1], each once, where n is
    the count the wrapper packs: an argument added on one side only
    fails here, not as a fault on the card."""
    idx = [int(i) for i in re.findall(r"a\[(\d+)\]", _entry_body(source,
                                                                 name))]
    n = LIBS[source].packers[name].size // 8
    assert sorted(idx) == list(range(n))


def test_entry_points_are_the_sources():
    """Every ``extern "C"`` entry point of each source is bound by its
    wrapper, and nothing else."""
    for source, lib in LIBS.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        extern = text[text.index('extern "C"'):]
        names = set(re.findall(r"^(?:extern \"C\" )?int (\w+)\(", extern,
                               re.M))
        assert names == set(lib.signatures), source


def test_launch_counts_reset_in_place():
    """``launches`` is one dict per library that ``reset`` zeroes in
    place, so a caller holding it sees the reset."""
    held = tts.launches
    held["topk_merge_path"] += 3
    tts.reset_launches()
    assert held is tts.launches and set(held.values()) == {0}


def test_packing_takes_null_pointers_as_zero():
    """A missing operand (no norms, no running list) goes to C as 0."""
    packer = tts._LIB.packers["topk_score_keys"]
    args = [1, 2, 3, 4, 5, 6, tts._ptr(None), 8, 9, 10, 11, 12]
    assert packer.unpack(packer.pack(*args))[6] == 0


def test_device_guard_without_an_index_enters_nothing():
    """A device with no index means the current one: the guard is the
    shared no-op context, and CUDA is not touched."""
    assert _build.on_device(torch.device("cuda")) is _build._NO_GUARD
