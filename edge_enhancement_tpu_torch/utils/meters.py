"""Metric accumulators and the reference-format log lines, as
edge_enhancement_tpu/utils/meters.py (same strings, so the same log
scrapers read both packages' logs)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def train_line(epoch, i, n, batch_time, data_time, losses, top1, top5) -> str:
    return ("Epoch: [{0}][{1}/{2}]\t"
            "Time {bt.val:.3f} ({bt.avg:.3f})\t"
            "Data {dt.val:.3f} ({dt.avg:.3f})\t"
            "Loss {loss.val:.4f} ({loss.avg:.4f})\t"
            "Prec@1 {t1.val:.3f} ({t1.avg:.3f})\t"
            "Prec@5 {t5.val:.3f} ({t5.avg:.3f})\t").format(
        epoch, i, n, bt=batch_time, dt=data_time, loss=losses, t1=top1, t5=top5)


def clean_summary(top1: AverageMeter, top5: AverageMeter) -> str:
    return " * Clean Prec@1 {t1.avg:.3f} Prec@5 {t5.avg:.3f}".format(t1=top1, t5=top5)


def adv_summary(top1: AverageMeter, top5: AverageMeter) -> str:
    return " * Adv Prec@1 {t1.avg:.3f} Prec@5 {t5.avg:.3f}".format(t1=top1, t5=top5)
