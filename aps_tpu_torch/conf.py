#!/usr/bin/env python
"""YAML experiment-config loading and the token dictionary (the port's own
copy of what it needs from aps_tpu/conf.py: load_dict, dump_dict,
load_am_conf, load_lm_conf, load_ss_conf). Same schema: required keys {nnet, nnet_conf, task,
task_conf, data_conf, trainer_conf}; AM configs get vocab_size/sos/eos from
the dict file and the CTC blank id appended as len(vocab)."""

import json
import re
from typing import Dict, List, Tuple

from aps_tpu_torch.const import EOS_TOKEN, SOS_TOKEN, UNK_TOKEN

required_keys = [
    "nnet", "nnet_conf", "task", "task_conf", "data_conf", "trainer_conf"
]
all_am_options = required_keys + [
    "enh_transform", "asr_transform", "cmd_args"
]
all_ss_options = required_keys + ["enh_transform", "cmd_args"]
all_lm_options = required_keys + ["cmd_args", "sos", "eos"]


def load_yaml(path) -> Dict:
    """A YAML file. JSON text (what dump_conf writes) is read as JSON, so
    its numbers come back as written; any other file goes through PyYAML."""
    with open(path, "r") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml
        return yaml.full_load(text)


def dump_conf(conf: Dict) -> str:
    """conf as JSON text that is also valid YAML with the same values: YAML
    1.1 reads a float only with a dot in it, so json's "1e-05" (a string to
    PyYAML) is written "1.0e-05"."""
    text = json.dumps(conf, indent=2)
    return re.sub(r"(?<![\w.\"])(-?\d+)(e[-+]\d+)(?![\w\"])", r"\1.0\2", text)


def load_dict(dict_path: str,
              reverse: bool = False,
              required: List[str] = [UNK_TOKEN]) -> Dict:
    """Load token dict ("word id" per line); check required tokens exist."""
    vocab = {}
    with open(dict_path, "r", encoding="utf-8") as f:
        for line in f:
            toks = line.strip().split()
            if len(toks) != 2:
                raise RuntimeError(f"Bad dict line: {line.strip()}")
            vocab[toks[0]] = int(toks[1])
    for token in required:
        if token not in vocab:
            raise ValueError(f"Missing token {token} in {dict_path}")
    if reverse:
        return {v: k for k, v in vocab.items()}
    return vocab


def dump_dict(dict_path: str, vocab: Dict, reverse: bool = False) -> None:
    with open(dict_path, "w", encoding="utf-8") as f:
        for k, v in sorted(vocab.items(), key=lambda kv: kv[1]):
            if reverse:
                f.write(f"{v} {k}\n")
            else:
                f.write(f"{k} {v}\n")


def check_conf(conf: Dict, required_keys: List[str],
               all_keys: List[str]) -> Dict:
    for key in required_keys:
        if key not in conf:
            raise ValueError(f"Missing '{key}' in yaml config")
    for key in conf:
        if key not in all_keys:
            raise ValueError(f"Unknown configuration key: {key}")
    return conf


def load_ss_conf(yaml_conf: str) -> Dict:
    """Load yaml configuration for speech enhancement/separation tasks."""
    return check_conf(load_yaml(yaml_conf), required_keys, all_ss_options)


def load_lm_conf(yaml_conf: str, dict_path: str) -> Tuple[Dict, Dict]:
    """Load yaml configuration for language model tasks: vocab_size from
    the dict; its <sos>/<eos> ids at the top level of the configuration
    (they feed the LM loaders, not the task)."""
    conf = check_conf(load_yaml(yaml_conf), required_keys, all_lm_options)
    vocab = load_dict(dict_path)
    conf["nnet_conf"]["vocab_size"] = len(vocab)
    sos = vocab.get(SOS_TOKEN, -1)
    eos = vocab.get(EOS_TOKEN, -1)
    if sos < 0 or eos < 0:
        raise RuntimeError(f"Missing {SOS_TOKEN}/{EOS_TOKEN} in {dict_path}")
    conf["sos"] = sos
    conf["eos"] = eos
    return conf, vocab


def load_am_conf(yaml_conf: str, dict_path: str) -> Tuple[Dict, Dict]:
    """Load yaml configuration for acoustic model tasks (vocab injection)."""
    conf = check_conf(load_yaml(yaml_conf), required_keys, all_am_options)

    vocab = load_dict(dict_path)
    nnet_conf = conf["nnet_conf"]
    nnet_conf["vocab_size"] = len(vocab)

    task_conf = conf["task_conf"]
    use_ctc = "ctc_weight" in task_conf and task_conf["ctc_weight"] > 0
    is_transducer_or_ctc = conf["task"] in ("asr@transducer", "asr@ctc")
    if not is_transducer_or_ctc:
        sos = vocab.get(SOS_TOKEN, -1)
        eos = vocab.get(EOS_TOKEN, -1)
        if sos < 0 or eos < 0:
            raise RuntimeError(
                f"Missing {SOS_TOKEN}/{EOS_TOKEN} in {dict_path}")
        nnet_conf["sos"] = sos
        nnet_conf["eos"] = eos
    if use_ctc or is_transducer_or_ctc:
        # CTC/transducer blank id: appended at end of the vocabulary
        conf["task_conf"]["blank"] = len(vocab)
        nnet_conf["vocab_size"] += 1
        if use_ctc:
            nnet_conf["ctc"] = True
    return conf, vocab
