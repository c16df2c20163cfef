#!/usr/bin/env python
"""Registries of the port, keyed by the same names as aps_tpu/libs.py.

Only what the port has so far is registered: the "asr" transform and the
"asr@xfmr" model. Registration happens when the defining module is
imported; the factory functions import them on first use."""

import importlib

ASR_SUBMODULES = ["aps_tpu_torch.asr.att"]
TRANSFORM_SUBMODULES = ["aps_tpu_torch.transform.asr"]


class Register(dict):
    """A name -> class dict populated by decoration."""

    def __init__(self, name: str):
        super(Register, self).__init__()
        self.name = name

    def register(self, alias: str):

        def add(obj):
            if alias in self:
                raise ValueError(f"{alias} is already registered in "
                                 f"{self.name}")
            self[alias] = obj
            return obj

        return add


class ApsRegisters(object):
    asr = Register("asr")
    transform = Register("transform")


def _lookup(registry: Register, modules, name: str):
    for module in modules:
        importlib.import_module(module)
    if name not in registry:
        raise ValueError(f"{name} is not in the port's {registry.name} "
                         f"registry yet (has: {', '.join(sorted(registry))})")
    return registry[name]


def aps_asr_nnet(name: str):
    return _lookup(ApsRegisters.asr, ASR_SUBMODULES, name)


def aps_transform(name: str):
    return _lookup(ApsRegisters.transform, TRANSFORM_SUBMODULES, name)
