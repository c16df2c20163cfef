#!/usr/bin/env python
"""Registries of the port, keyed by the same names as aps_tpu/libs.py.

Only what the port has so far is registered: the "asr" transform, the
"asr@xfmr" model, the "asr@ctc_xent" and "asr@ctc" tasks, the "dp" trainer,
the "am@raw" loader and the "word" tokenizer. Registration happens
when the defining module is imported; the factory functions import them on
first use."""

import importlib

ASR_SUBMODULES = ["aps_tpu_torch.asr.att"]
TRANSFORM_SUBMODULES = ["aps_tpu_torch.transform.asr"]
TASK_SUBMODULES = ["aps_tpu_torch.task.asr"]
TRAINER_SUBMODULES = ["aps_tpu_torch.trainer.dp"]
LOADER_SUBMODULES = ["aps_tpu_torch.loader.am.raw"]
TOKENIZER_SUBMODULES = ["aps_tpu_torch.tokenizer.word"]


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
    task = Register("task")
    trainer = Register("trainer")
    loader = Register("loader")
    tokenizer = Register("tokenizer")


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


def aps_task(name: str, nnet, **kwargs):
    """Build the registered task `name` around nnet."""
    return _lookup(ApsRegisters.task, TASK_SUBMODULES, name)(nnet, **kwargs)


def aps_trainer(name: str):
    return _lookup(ApsRegisters.trainer, TRAINER_SUBMODULES, name)


def aps_tokenizer(name: str):
    return _lookup(ApsRegisters.tokenizer, TOKENIZER_SUBMODULES, name)


def aps_dataloader(fmt: str = "am@raw", **kwargs):
    return _lookup(ApsRegisters.loader, LOADER_SUBMODULES, fmt)(**kwargs)


def start_trainer(trainer: str,
                  conf: dict,
                  nnet,
                  args,
                  device,
                  reduction_tag: str = "none",
                  other_loader_conf=None):
    """Assemble task + trainer + loaders from an experiment config and run
    (port of aps_tpu/libs.py::start_trainer for one device). Returns the
    trainer."""
    import json
    import os

    task = aps_task(conf["task"], nnet, **conf.get("task_conf", {}))
    trn = aps_trainer(trainer)(task,
                               device=device,
                               checkpoint=args.checkpoint,
                               resume=getattr(args, "resume", ""),
                               prog_interval=getattr(args, "prog_interval",
                                                     100),
                               reduction_tag=reduction_tag,
                               seed=int(getattr(args, "seed", 777)),
                               **conf["trainer_conf"])
    # the assembled config beside the checkpoints rebuilds the model for
    # evaluation; JSON text is valid YAML
    conf["cmd_args"] = vars(args)
    with open(os.path.join(args.checkpoint, "train.yaml"), "w") as f:
        json.dump(conf, f, indent=2)

    data_conf = conf["data_conf"]
    loader_conf = {
        "fmt": data_conf["fmt"],
        "num_workers": getattr(args, "num_workers", 0),
        "max_batch_size": args.batch_size,
    }
    loader_conf.update(data_conf.get("loader", {}))
    loader_conf.update(other_loader_conf or {})
    trn_loader = aps_dataloader(train=True, **loader_conf,
                                **data_conf["train"])
    # validation may need a smaller batch: batch_size / dev_batch_factor
    dev_factor = max(float(getattr(args, "dev_batch_factor", 1)), 1.0)
    dev_loader_conf = dict(loader_conf)
    dev_loader_conf["max_batch_size"] = max(
        int(loader_conf["max_batch_size"] / dev_factor), 1)
    dev_loader = aps_dataloader(train=False, **dev_loader_conf,
                                **data_conf["valid"])
    trn.run(trn_loader, dev_loader, num_epochs=getattr(args, "epochs", 50))
    return trn
