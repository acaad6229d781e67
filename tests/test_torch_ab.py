"""The A/B tools' CPU-side parts: importing another checkout's modules beside
this one's (``opensora_torch/tools/ab.py``) and the cases
``tools/flash_ab.py`` times, held to the card check's."""

import os
import sys

import pytest

from opensora_torch.ops import flash_attention as tflash
from opensora_torch.tools import ab, flash_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_checkout_gives_a_second_copy_and_restores_this_one():
    """The other checkout's module is a module of its own (its own _build,
    so its own kernels and launch counts); this checkout's modules are back
    in sys.modules after."""
    before = {n: m for n, m in sys.modules.items() if n.startswith("opensora_torch")}
    other = ab.import_checkout(REPO, "opensora_torch.ops.flash_attention")
    assert other is not tflash and other._build is not tflash._build
    assert os.path.abspath(other.__file__) == os.path.abspath(tflash.__file__)
    assert {n: m for n, m in sys.modules.items() if n.startswith("opensora_torch")} == before


def test_import_checkout_refuses_a_module_from_elsewhere(tmp_path):
    """A root that holds no copy of the package must not silently give this
    checkout's module."""
    before = sys.modules["opensora_torch.ops.flash_attention"]
    with pytest.raises((RuntimeError, ModuleNotFoundError)):
        ab.import_checkout(str(tmp_path), "opensora_torch.ops.flash_attention")
    assert sys.modules["opensora_torch.ops.flash_attention"] is before


def test_flash_ab_cases_are_the_card_checks_d512_cases():
    """flash_ab times the D = 512 forward at every case of chip_smoke.py's
    phase 2 and the backward at every case of its phase 2d."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    fwd = {(shape, cb, qscale, lk[0] if lk else None) for _, shape, cb, qscale, *lk in chip_smoke.ATTENTION_CASES
           if shape[3] == 512}
    bwd = {(shape, cb, lk[0] if lk else None) for _, shape, cb, *lk in chip_smoke.BWD_D512_CASES}
    assert {case[1:] for case in flash_ab.FWD_CASES} == fwd
    assert {case[1:] for case in flash_ab.BWD_CASES} == bwd
    assert (flash_ab.OUT_RTOL, flash_ab.LSE_TOL, flash_ab.BWD_RTOL) == (
        chip_smoke.OUT_RTOL, chip_smoke.LSE_TOL, chip_smoke.BWD_RTOL)
