"""The port's roofline math (launch/roofline.py) against the reference's.

``analytic_flops``, ``analytic_bytes``, ``model_flops`` and the ring
model ``_ring_bytes`` are f64 Python arithmetic in both packages, so
they must agree to 1e-12 relative for every arch × shape × device count.
``roofline``'s terms are in seconds against each package's own peak
constants (v5e in the reference, H100 SXM5 in the port), so they must
agree after rescaling by the ratio of the constants.
"""
import math

import pytest

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs

DEVICES = (1, 8, 16, 64, 256, 512)
REL = 1e-12


def close(a, b, rel=REL):
    return math.isclose(a, b, rel_tol=rel, abs_tol=0.0) or a == b


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_analytic_terms_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for shape in jspecs.SHAPES:
        jc, tc = jspecs.SHAPES[shape], tspecs.SHAPES[shape]
        assert close(troof.analytic_flops(tcfg, tc),
                     jroof.analytic_flops(jcfg, jc))
        assert close(troof.model_flops(tcfg, tc),
                     jroof.model_flops(jcfg, jc))
        for n in DEVICES:
            for md in ("float32", "bfloat16", "int8"):
                for ffn in ("tp", "dp"):
                    assert close(
                        troof.analytic_bytes(tcfg, tc, n, md, ffn),
                        jroof.analytic_bytes(jcfg, jc, n, md, ffn)), \
                        (shape, n, md, ffn)


@pytest.mark.parametrize("op", jroof.COLLECTIVES + ("send",))
def test_ring_bytes_match_reference(op):
    for out_bytes in (0, 1, 4096, 3 * 2 ** 30 + 7):
        for n in (1, 2, 4, 16, 256, 512):
            assert close(troof._ring_bytes(op, out_bytes, n),
                         jroof._ring_bytes(op, out_bytes, n))


@pytest.mark.parametrize("arch", ["granite-3-2b", "dbrx-132b",
                                  "jamba-1.5-large-398b", "whisper-small"])
def test_roofline_terms_match_reference_rescaled(arch):
    """The same per-device inputs give each term × its constant equal,
    so the port's terms are the reference's rescaled by the ratio of the
    peak constants; the model FLOPs and usefulness ratio are equal."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    rates = (("compute_s", jmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_BF16),
             ("memory_s", jmesh.HBM_BW, tmesh.HBM_BW),
             ("collective_s", jmesh.ICI_BW, tmesh.LINK_BW))
    for shape in jspecs.SHAPES:
        jc, tc = jspecs.SHAPES[shape], tspecs.SHAPES[shape]
        for n in (256, 512):
            flops = jroof.analytic_flops(jcfg, jc) / n
            nbytes = jroof.analytic_bytes(jcfg, jc, n)
            coll = 1.5e9
            meta = {"counts": {"all-reduce": 3}, "per_op_bytes": {}}
            ref = jroof.roofline(flops, nbytes, coll, meta, jcfg, jc, n)
            port = troof.roofline(flops, nbytes, coll, meta, tcfg, tc, n)
            for term, jr, tr in rates:
                assert close(port[term] * tr, ref[term] * jr)
            for key in ("model_flops", "useful_flops_ratio",
                        "flops_per_device", "bytes_per_device",
                        "collective_bytes_per_device"):
                assert close(port[key], ref[key])
            terms = {t: port[t] for t, _, _ in rates}
            assert port["dominant"] == max(terms, key=terms.get)


def test_roofline_without_collectives():
    """A cell whose collectives could not be traced keeps its collective
    term None, out of the bound and of the dominant term."""
    cfg, cell = treg.get_config("xlstm-350m"), tspecs.SHAPES["train_4k"]
    flops = troof.analytic_flops(cfg, cell) / 256
    nbytes = troof.analytic_bytes(cfg, cell, 256)
    r = troof.roofline(flops, nbytes, None, {}, cfg, cell, 256)
    assert r["collective_s"] is None
    assert r["dominant"] in ("compute_s", "memory_s")
    bound = max(r["compute_s"], r["memory_s"])
    assert close(r["roofline_fraction"], r["ideal_s"] / bound)


def test_h100_constants():
    """The datasheet values the roofline rests on (H100 SXM5, 700 W)."""
    assert tmesh.PEAK_FLOPS_BF16 == 989.4e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.LINK_BW == 50e9
