"""The byte floor's arithmetic at kron-21 (n 2,097,152, m 65,011,712)."""
import pytest

from bench import roofline

N, M = 2_097_152, 65_011_712
H100 = "NVIDIA H100 80GB HBM3"


def test_floor_bytes_at_kron21():
    assert roofline.spmv_floor_bytes(N, M, 1) == 285_212_676
    assert roofline.spmv_floor_bytes(N, M, 32) == 805_306_372


def test_floor_time_at_kron21():
    assert roofline.spmv_floor_s(N, M, 1, H100) == pytest.approx(
        85.138e-6, rel=1e-4)
    assert roofline.spmv_floor_s(N, M, 32, H100) == pytest.approx(
        0.24039e-3, rel=1e-4)


def test_unknown_card_has_no_floor():
    assert roofline.spmv_floor_s(N, M, 1, "cpu") is None
