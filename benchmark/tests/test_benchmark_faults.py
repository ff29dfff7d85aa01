"""A run with the timed path broken underneath comes out not correct: the
program's functions are replaced for the run (never the reference's), on
the CPU at test sizes, once for each fault that a cell can have on one
chip. (The exchange between chips is a fault of four-chip cells only.)"""

import pytest

from benchmark.tests import tiny

from edge_enhancement_tpu_torch.attacks import pgd
from edge_enhancement_tpu_torch.objectives import methods
from edge_enhancement_tpu_torch.train import trainer


def _half(ce):
    """cross_entropy with its batch mean over the first half of the rows."""
    def broken(logits, labels, reduction="mean"):
        if reduction == "mean":
            n = len(labels) // 2
            return ce(logits[:n], labels[:n], reduction)
        return ce(logits, labels, reduction)
    return broken


def _altered(ce):
    """cross_entropy a thousandth off where it is produced."""
    def broken(logits, labels, reduction="mean"):
        return ce(logits, labels, reduction) * 1.001
    return broken


def _start_off(mp):
    """PGD's uniform start drawn at half its radius, from the same draws."""
    noise = pgd.uniform_init_noise
    mp.setattr(pgd, "uniform_init_noise", lambda x, eps, gen: noise(x, eps / 2, gen))


FAULTS = {
    # a step that returns its state unchanged
    "state_unchanged": lambda mp: mp.setattr(trainer, "sgd_update", lambda *a, **k: None),
    # half of the batch left out, the mean taken over the rest
    "half_batch": lambda mp: [mp.setattr(m, "cross_entropy", _half(m.cross_entropy))
                              for m in (methods, trainer)],
    # the attack's start off its draw
    "start_off": _start_off,
    # an answer (the loss) altered where it is produced
    "answer_altered": lambda mp: [mp.setattr(m, "cross_entropy", _altered(m.cross_entropy))
                                  for m in (methods, trainer)],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("real", sorted(tiny.TINY))
def test_fault_is_not_correct(real, fault, tiny_root, capsys, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, err = tiny.run(tiny_root, tiny.TINY[real], capsys, seed=777)
    assert result["correct"] is False, err


@pytest.mark.parametrize("real", sorted(tiny.TINY))
def test_sound_run_is_correct(real, tiny_root, capsys):
    result, err = tiny.run(tiny_root, tiny.TINY[real], capsys, seed=778)
    assert result["correct"] is True, err
