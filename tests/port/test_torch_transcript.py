"""Port challenge sources against the JAX package's: the same absorb/draw
script gives identical draws."""

import numpy as np
import pytest
import torch

from zkdl_tpu.sumcheck import transcript as jt
from zkdl_tpu_torch.sumcheck import transcript as pt


def _script(src, arrays):
    """absorb, draw, absorb an array / a tensor, draw again."""
    out = [np.asarray(src.random_vec(3))]
    src.absorb(b"statement")
    for a in arrays:
        src.absorb_array(a)
        out.append(np.asarray(src.random_vec(2)))
    return np.concatenate(out)


@pytest.mark.parametrize("mode", ["seeded", "fiat_shamir"])
def test_same_script_same_draws(mode):
    rng = np.random.default_rng(50)
    arrays = [rng.integers(0, 1 << 32, size=s, dtype=np.uint32) for s in [(5, 3, 8), (8,), (4, 12)]]
    make = {"seeded": (lambda: jt.SeededRng(12345), lambda: pt.SeededRng(12345)),
            "fiat_shamir": (jt.FiatShamir, pt.FiatShamir)}[mode]
    want = _script(make[0](), arrays)
    got = _script(make[1](), [torch.from_numpy(a) for a in arrays])
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_random_vec_is_a_host_uint32_tensor():
    v = pt.FiatShamir().random_vec(4)
    assert isinstance(v, torch.Tensor) and v.dtype == torch.uint32 and v.device.type == "cpu"
    assert v.shape == (4, 8)


def test_replay_round_trips():
    draws = pt.SeededRng(7).random_vec(5)
    rep = pt.Replay([draws[:2], draws[2:]])
    np.testing.assert_array_equal(rep.random_vec(5).numpy(), draws.numpy())
    with pytest.raises(ValueError):
        rep.random_vec(1)


def test_mt19937_matches_std():
    # std::mt19937 default seed: the 10000th output is 4123659995 (C++11 standard)
    m = pt.MT19937()
    for _ in range(9999):
        m.next_u32()
    assert m.next_u32() == 4123659995
