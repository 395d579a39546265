"""Device peaks keyed by ``device_kind`` (utils/roofline.py)."""
import pytest

from vcf2prot_tpu.utils import roofline


def test_known_device_kind_gives_h100_peaks():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p.bf16_flops == 989e12
    assert p.hbm_bps == 3.35e12
    # one second of the peak's work is a share of exactly 1
    assert roofline.mfu(989e12, 1.0, "NVIDIA H100 80GB HBM3") == 1.0
    assert roofline.hbm_fraction(3.35e12, 2.0, "NVIDIA H100 80GB HBM3") == 0.5


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks(kind)
    with pytest.raises(KeyError):
        roofline.mfu(1.0, 1.0, kind)
