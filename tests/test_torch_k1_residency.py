"""Where K1 and K1p hold x in L2, on the CPU: the residency rule as a pure
function of x's bytes and the device's two L2 attributes, the persisting
set-aside the wrapper grants (once per device and size, never inside a
capture). The kernels themselves run only on the card
(``chip_smoke.py``)."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel

MB = 1 << 20
#: an H100 80GB HBM3's L2 bytes and its largest persisting set-aside, as
#: cudaDeviceGetAttribute reads them
H100_L2, H100_PERSISTING = 52_428_800, 32_768_000


@pytest.mark.parametrize(
    "x_bytes, l2, persisting, share",
    [
        # far below L2: a 500k-row x is held whole
        (2 * MB, H100_L2, H100_PERSISTING, 1.0),
        # near L2: a scale-23 graph's x, 8,388,608 floats, is held up to the set-aside
        (33_554_432, H100_L2, H100_PERSISTING, H100_PERSISTING / 33_554_432),
        # far above L2: only the set-aside's share
        (320 * MB, H100_L2, H100_PERSISTING, H100_PERSISTING / (320 * MB)),
        # a device that reports no persisting room holds nothing
        (2 * MB, H100_L2, 0, 0.0),
        # a set-aside reported above L2 is capped at L2
        (100 * MB, 40 * MB, 60 * MB, 0.4),
        # no columns
        (0, H100_L2, H100_PERSISTING, 0.0),
    ],
    ids=["far_below_l2", "near_l2", "far_above_l2", "no_persisting_room", "room_capped_at_l2",
         "empty_x"],
)
def test_resident_share(x_bytes, l2, persisting, share):
    got = csr5_kernel.resident_share(x_bytes, l2, persisting)
    assert got == pytest.approx(share, rel=1e-12, abs=0.0)
    assert 0.0 <= got <= 1.0
    # the held lines fit the set-aside the device allows
    assert math.ceil(got * x_bytes) <= min(l2, persisting)


class _FakeLib:
    """The two L2 entry points of ``csr5_spmv.cu``, recording their calls;
    the device rounds a limit up to whole MiB."""

    def __init__(self, l2=H100_L2, persisting=H100_PERSISTING, limit=0):
        self.attrs = (l2, persisting)
        self.limit = limit
        self.attr_calls, self.grants = [], []

    def csr5_l2_attributes(self, dev, out):
        self.attr_calls.append(dev)
        out[0], out[1] = self.attrs
        return 0

    def csr5_grant_persisting_l2(self, dev, want, granted):
        self.grants.append((dev, want))
        if self.limit < want:
            self.limit = -(-want // MB) * MB
        granted._obj.value = self.limit
        return 0

    def csr5_cuda_error_string(self, rc):
        return b"fake"


@pytest.fixture
def clean_l2_state(monkeypatch):
    monkeypatch.setattr(csr5_kernel, "_l2_attributes", {})
    monkeypatch.setattr(csr5_kernel, "_setaside", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def test_setaside_is_granted_once_per_device_and_only_grows(clean_l2_state, monkeypatch):
    lib = _FakeLib()
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert csr5_kernel._residency(lib, d0, 2 * MB) == 1.0
    assert lib.grants == [(0, 2 * MB)]
    # the same or a smaller x asks for nothing more
    csr5_kernel._residency(lib, d0, 2 * MB)
    csr5_kernel._residency(lib, d0, MB)
    assert lib.grants == [(0, 2 * MB)]
    # a larger x raises it, up to the device's largest set-aside
    share = csr5_kernel._residency(lib, d0, 33_554_432)
    assert share == pytest.approx(H100_PERSISTING / 33_554_432)
    assert lib.grants == [(0, 2 * MB), (0, H100_PERSISTING)]
    csr5_kernel._residency(lib, d0, 320 * MB)
    assert lib.grants == [(0, 2 * MB), (0, H100_PERSISTING)]
    # each device has its own set-aside; the attributes are read once a device
    csr5_kernel._residency(lib, d1, 2 * MB)
    assert lib.grants[-1] == (1, 2 * MB)
    assert lib.attr_calls == [0, 1]


def test_setaside_waits_outside_a_capture(clean_l2_state, monkeypatch):
    lib = _FakeLib()
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    # the share stays what x's bytes and the attributes give
    assert csr5_kernel._residency(lib, dev, 33_554_432) == pytest.approx(
        H100_PERSISTING / 33_554_432)
    assert lib.grants == []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    csr5_kernel._residency(lib, dev, 33_554_432)
    assert lib.grants == [(0, H100_PERSISTING)]


def test_a_larger_limit_already_set_is_kept(clean_l2_state):
    lib = _FakeLib(limit=10 * MB)
    dev = torch.device("cuda", 0)
    csr5_kernel._residency(lib, dev, 2 * MB)
    assert lib.limit == 10 * MB
    # the limit the device reported covers later requests up to it
    csr5_kernel._residency(lib, dev, 8 * MB)
    assert lib.grants == [(0, 2 * MB)]


def test_no_persisting_room_grants_nothing(clean_l2_state):
    lib = _FakeLib(persisting=0)
    assert csr5_kernel._residency(lib, torch.device("cuda", 0), 2 * MB) == 0.0
    assert lib.grants == []


def test_failed_attribute_read_raises(clean_l2_state):
    lib = _FakeLib()
    lib.csr5_l2_attributes = lambda dev, out: 1
    with pytest.raises(RuntimeError, match="L2 attributes"):
        csr5_kernel._residency(lib, torch.device("cuda", 0), MB)
