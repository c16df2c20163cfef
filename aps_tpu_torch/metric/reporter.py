#!/usr/bin/env python
"""Metric reporters (the port's own copy of aps_tpu/metric/reporter.py:
AverageReporter, WerReporter)."""

from collections import defaultdict
from typing import Optional, Tuple

from aps_tpu_torch.io.base import BaseReader


class MetricReporter(object):

    def __init__(self,
                 spk2class: Optional[str] = None,
                 name: str = "UNK",
                 unit: str = "UNK") -> None:
        self.s2c = BaseReader(spk2class) if spk2class else None
        self.val = defaultdict(float)
        self.name = name
        self.unit = unit

    def report(self):
        raise NotImplementedError


class AverageReporter(MetricReporter):
    """For SDR / PESQ / STOI / SiSNR."""

    def __init__(self, spk2class=None, name="UNK", unit="UNK") -> None:
        super(AverageReporter, self).__init__(spk2class=spk2class,
                                              name=name, unit=unit)
        self.cnt = defaultdict(int)

    def add(self, key: str, val: float) -> None:
        cls_str = self.s2c[key] if self.s2c else "NG"
        self.val[cls_str] += val
        self.cnt[cls_str] += 1

    def report(self) -> None:
        print(f"{self.name} ({self.unit}) Report: ")
        tot_utt = sum(self.cnt.values())
        tot_val = sum(self.val.values())
        print(f"Total: {tot_val / tot_utt:.3f}, {tot_utt:d} utterances")
        if len(self.val) != 1:
            for cls_str in self.val:
                print(f"\t{cls_str}: "
                      f"{self.val[cls_str] / self.cnt[cls_str]:.3f}, "
                      f"{self.cnt[cls_str]:d} utterances")


class WerReporter(MetricReporter):
    """For WER / CER with SUB/INS/DEL breakdown."""

    def __init__(self, spk2class=None, name="UNK", unit="UNK") -> None:
        super(WerReporter, self).__init__(spk2class=spk2class, name=name,
                                          unit=unit)
        self.tot = defaultdict(float)
        self.err = {
            "sub": defaultdict(float),
            "ins": defaultdict(float),
            "del": defaultdict(float)
        }
        self.cnt = 0

    def add(self, key: str, val: Tuple[float, float, float],
            tot: int) -> None:
        cls_str = self.s2c[key] if self.s2c else "NG"
        self.tot[cls_str] += tot
        self.val[cls_str] += sum(val)
        self.err["sub"][cls_str] += val[0]
        self.err["ins"][cls_str] += val[1]
        self.err["del"][cls_str] += val[2]
        self.cnt += 1

    def report(self) -> None:
        print(f"{self.name} ({self.unit}) Report: ")
        sum_err = sum(self.val.values())
        sum_len = sum(self.tot.values())
        wer = sum_err * 100 / sum_len
        errs = {
            key: sum(self.err[key][c] for c in self.val)
            for key in self.err
        }
        errs_str = (f"{errs['sub']:.0f}/{errs['ins']:.0f}/"
                    f"{errs['del']:.0f}")
        print(f"Total ({self.cnt:.0f} utterances): "
              f"{sum_err:.0f}/{sum_len:.0f} = {wer:.2f}{self.unit}, "
              f"SUB/INS/DEL = {errs_str}")
        if len(self.val) != 1:
            for cls_str in self.val:
                cls_wer = self.val[cls_str] * 100 / self.tot[cls_str]
                print(f"  {cls_str}: {self.val[cls_str]:.0f}/"
                      f"{self.tot[cls_str]:.0f} = "
                      f"{cls_wer:.2f}{self.unit}")
