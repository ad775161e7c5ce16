"""fused_kernels.philox_gumbel_noise, the noise that the fused kernels add
to a score in 'gumbel' mode, held to Philox4x32-10 words computed by hand:
counter (row, g // 4, 0, 0) keyed by the 64-bit seed, word g % 4, g =
slot_offset + slot.  On the card, chip_smoke.py feeds it to each kernel's
'gumbel_host' mode and holds the draws to its 'gumbel' draws."""

import pytest
import torch

from distributions_tpu_torch import config
from distributions_tpu_torch.ops import fused_kernels as fk

torch.set_num_threads(1)
config.set_default_device('cpu')

M32 = 0xFFFFFFFF


def philox_scalar(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on Python ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & M32)
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    assert philox_scalar((0, 0, 0, 0), (0, 0)) == (
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)
    assert philox_scalar((M32,) * 4, (M32, M32)) == (
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)
    assert philox_scalar(
        (0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
        (0xa4093822, 0x299f31d0)) == (
        0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)


def noise_by_hand(seed, row, g, fast=False):
    word = philox_scalar((row, g // 4, 0, 0), (seed & M32, seed >> 32))[g % 4]
    u = torch.tensor(word & 0x00FFFFFF, dtype=torch.float32) \
        * 5.960464477539063e-08
    log_ = fk.fast_log if fast else torch.log
    return -log_(torch.clamp(-log_(u), min=6e-8))


CELLS = ((0, 0), (0, 3), (1, 4), (4, 10), (3, 7), (2, 9), (6, 1))


@pytest.mark.parametrize('fast', [False, True])
@pytest.mark.parametrize('seed', [0, 12345, 0x123456789ABCDEF0,
                                  (1 << 64) - 1])
def test_noise_is_the_cells_philox_word(seed, fast):
    noise = fk.philox_gumbel_noise(seed, 7, 11, fast=fast)
    assert noise.shape == (7, 11) and noise.dtype == torch.float32
    for row, slot in CELLS:
        assert torch.equal(noise[row, slot],
                           noise_by_hand(seed, row, slot, fast)), (row, slot)


@pytest.mark.parametrize('slot_offset', [0, 2, 6, 256])
def test_offset_noise_is_a_column_slice_of_the_whole(slot_offset):
    B, C = 7, 13
    for fast in (False, True):
        whole = fk.philox_gumbel_noise(99, B, slot_offset + C, fast=fast)
        part = fk.philox_gumbel_noise(99, B, C, slot_offset=slot_offset,
                                      fast=fast)
        assert torch.equal(part, whole[:, slot_offset:slot_offset + C])
    # and the cells of the shard are the words of their global slots
    part = fk.philox_gumbel_noise(5, B, C, slot_offset=slot_offset)
    for row, slot in CELLS:
        assert torch.equal(part[row, slot],
                           noise_by_hand(5, row, slot_offset + slot))


def test_noise_is_standard_gumbel():
    """Mean Euler's gamma, variance pi^2 / 6, within five standard errors
    of 51,200 draws."""
    x = fk.philox_gumbel_noise(7, 200, 256).double()
    n = x.numel()
    assert abs(float(x.mean()) - 0.5772156649) < 5 * 1.2825 / n ** 0.5
    assert abs(float(x.var()) - 1.6449340668) < 5 * 2.9 / n ** 0.5


def test_noise_rejects_bad_seeds():
    with pytest.raises(ValueError):
        fk.philox_gumbel_noise(-1, 2, 2)
    with pytest.raises(ValueError):
        fk.philox_gumbel_noise(1 << 64, 2, 2)
