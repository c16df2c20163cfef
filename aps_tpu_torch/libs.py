#!/usr/bin/env python
"""Registries of the port, keyed by the same names as aps_tpu/libs.py.

Only what the port has so far is registered: the "asr" and "enh"
transforms, the "asr@xfmr", "asr@att", "asr@ctc", "asr@enh_xfmr",
"asr@enh_att", "asr@transducer", "asr@xfmr_transducer", "asr@rnn_lm",
"asr@xfmr_lm", "sse@time_tcn",
"sse@freq_tcn", "sse@base_rnn", "sse@rnn_enh_ml", "sse@time_dprnn",
"sse@freq_dprnn", "sse@demucs", "sse@dcunet", "sse@dccrn",
"sse@dense_unet", "sse@time_sepformer", "sse@freq_sepformer",
"sse@freq_xfmr", "sse@dfsmn", "sse@phasen", "sse@chimera++",
"streaming_asr@ctc", "streaming_asr@transducer", "rt_sse@dfsmn" and
"rt_sse@freq_xfmr" models, the
"asr@ctc_xent", "asr@ctc", "asr@transducer", "asr@lm", "sse@sisnr",
"sse@snr", "sse@wa", "sse@freq_linear_sa", "sse@freq_mel_sa", "sse@time_linear_sa",
"sse@time_mel_sa", "sse@complex_mapping", "sse@complex_masking",
"sse@enh_ml" and "sse@ts" tasks, the
"dp" trainer, the "am@raw", "am@kaldi", "am@simu_cmd", "lm@utt",
"lm@bptt", "se@chunk", "se@simu_cmd" and "se@config" loaders and
the "word", "char" and "subword" tokenizers; the multi-channel front ends
"rnn_mask_mvdr", "time_invar", "time_invar_att", "time_variant" and
"google_clp" are in their own registry, aps_tpu_torch.asr.filter.conv.
EnhFrontEnds ("enh_filter", as in aps_tpu), the encoders in
aps_tpu_torch.asr.base.encoder.BaseEncoder, the decoder attentions in
aps_tpu_torch.asr.base.attention.AsrAtt and the schedule-sampling
schedulers in aps_tpu_torch.trainer.ss.SsScheduler. Registration happens
when the defining module is imported; the factory functions import them on
first use."""

import importlib

ASR_SUBMODULES = ["aps_tpu_torch.asr.att", "aps_tpu_torch.asr.ctc",
                  "aps_tpu_torch.asr.enh_att",
                  "aps_tpu_torch.asr.lm.rnn",
                  "aps_tpu_torch.asr.lm.transformer",
                  "aps_tpu_torch.asr.transducers",
                  "aps_tpu_torch.streaming_asr.ctc",
                  "aps_tpu_torch.streaming_asr.transducers"]
SSE_SUBMODULES = ["aps_tpu_torch.sse.bss.tcn", "aps_tpu_torch.sse.toy",
                  "aps_tpu_torch.sse.unsuper.rnn",
                  "aps_tpu_torch.sse.bss.dprnn",
                  "aps_tpu_torch.sse.bss.sepformer",
                  "aps_tpu_torch.sse.bss.transformer",
                  "aps_tpu_torch.sse.bss.dccrn",
                  "aps_tpu_torch.sse.bss.dense_unet",
                  "aps_tpu_torch.sse.bss.chimera",
                  "aps_tpu_torch.sse.enh.demucs",
                  "aps_tpu_torch.sse.enh.dcunet",
                  "aps_tpu_torch.sse.enh.dfsmn",
                  "aps_tpu_torch.sse.enh.phasen",
                  "aps_tpu_torch.rt_sse.enh.dfsmn",
                  "aps_tpu_torch.rt_sse.enh.transformer"]
TRANSFORM_SUBMODULES = ["aps_tpu_torch.transform.asr",
                        "aps_tpu_torch.transform.enh"]
TASK_SUBMODULES = ["aps_tpu_torch.task.asr", "aps_tpu_torch.task.sse",
                   "aps_tpu_torch.task.ml", "aps_tpu_torch.task.ts"]
TRAINER_SUBMODULES = ["aps_tpu_torch.trainer.dp"]
LOADER_SUBMODULES = ["aps_tpu_torch.loader.am.raw",
                     "aps_tpu_torch.loader.am.kaldi",
                     "aps_tpu_torch.loader.am.simu_cmd",
                     "aps_tpu_torch.loader.lm.utt",
                     "aps_tpu_torch.loader.lm.bptt",
                     "aps_tpu_torch.loader.se.chunk",
                     "aps_tpu_torch.loader.se.simu_cmd",
                     "aps_tpu_torch.loader.se.config"]
TOKENIZER_SUBMODULES = ["aps_tpu_torch.tokenizer.word",
                        "aps_tpu_torch.tokenizer.subword"]


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
    sse = Register("sse")
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


def aps_sse_nnet(name: str):
    return _lookup(ApsRegisters.sse, SSE_SUBMODULES, name)


def aps_nnet(name: str):
    """A registered nnet from either the asr or the sse registry."""
    for registry, modules in ((ApsRegisters.asr, ASR_SUBMODULES),
                              (ApsRegisters.sse, SSE_SUBMODULES)):
        for module in modules:
            importlib.import_module(module)
        if name in registry:
            return registry[name]
    raise ValueError(f"{name} is in neither the port's asr nor its sse "
                     "registry yet")


def aps_transform(name: str):
    return _lookup(ApsRegisters.transform, TRANSFORM_SUBMODULES, name)


def aps_task(name: str, nnet, **kwargs):
    """Build the registered task `name` around nnet. task_conf names the
    loss "objf" (examples/sse/wham/conf/1b_*.yaml), where the task's
    objf is its objective method: it becomes objf_name, as in aps_tpu."""
    if "objf" in kwargs:
        kwargs["objf_name"] = kwargs.pop("objf")
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
    import os

    from aps_tpu_torch.conf import dump_conf

    task = aps_task(conf["task"], nnet, **conf.get("task_conf", {}))
    trn = aps_trainer(trainer)(task,
                               device=device,
                               checkpoint=args.checkpoint,
                               resume=getattr(args, "resume", ""),
                               init=getattr(args, "init", ""),
                               save_interval=getattr(args, "save_interval",
                                                     -1),
                               prog_interval=getattr(args, "prog_interval",
                                                     100),
                               reduction_tag=reduction_tag,
                               seed=int(getattr(args, "seed", 777)),
                               **conf["trainer_conf"])
    # the assembled config beside the checkpoints rebuilds the model for
    # evaluation; JSON text that aps_tpu's YAML loader reads alike
    conf["cmd_args"] = vars(args)
    with open(os.path.join(args.checkpoint, "train.yaml"), "w") as f:
        f.write(dump_conf(conf))

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
    trn.run(trn_loader, dev_loader, num_epochs=getattr(args, "epochs", 50),
            eval_interval=getattr(args, "eval_interval", -1))
    return trn
