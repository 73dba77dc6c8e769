"""The kernel probe's build variants: each replacement it makes in a copy
of the headers matches the source exactly once, so a variant cannot drift
from the code it is meant to change."""

from __future__ import annotations

import pytest

from linpde_gp_tpu_torch import k2_probe
from linpde_gp_tpu_torch.ops import _cuda
from linpde_gp_tpu_torch.config import config

# The port runs on the card unless the CPU is asked for: these tests ask for
# it, and run the kernels' plain versions there.
config.set(device="cpu")


@pytest.mark.parametrize(
    "variant", ["unroll=1", "unroll=2", "unroll=4", "depth=16", "warps=8", "warps=16", "skip=eval", "skip=mma",
                "skip=eval+skip=mma", "depth=16+warps=16"])
def test_probe_variant_patches_a_copy(variant, tmp_path):
    csrc = k2_probe.patched_headers(variant, tmp_path)
    assert csrc == tmp_path / "csrc"
    source = (_cuda.CSRC / "gram_eval.cuh").read_text()
    patched = (csrc / "gram_eval.cuh").read_text()
    assert patched != source
    for old, new in k2_probe._patches(variant):
        assert source.count(old) == 1 and new in patched
    assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(p.name for p in _cuda.CSRC.glob("*.cuh"))


def test_probe_source_variant_builds_from_csrc(tmp_path):
    assert k2_probe.patched_headers("source", tmp_path) == _cuda.CSRC
    assert not (tmp_path / "csrc").exists()


def test_probe_unknown_variant_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown variant"):
        k2_probe.patched_headers("depth=16+tile=2", tmp_path)
