"""Task-string → SMB example-set factory.

Mirrors the reference's loader factories (ref: SeqRec/datasets/loading_SMB.py:6-262):
train task strings select the dataset variant + augmentation; test task strings
select the eval view. Returns integer `SMBExample` lists plus the corpus/layout.

Train tasks:   smb | smb_explicit | smb_explicit_back | smb_explicit_decoder[_N]
               | smb_augment_N
Test tasks:    smb | smb_explicit | smb_explicit_back | smb_augment_<ratio>
               | smb_explicit_valid | smb_valid_augment_<ratio> | smb_drop_gt
"""

from __future__ import annotations

from dataclasses import dataclass

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.smb import SMBCorpus, SMBExample, SMBExampleBuilder, TokenLayout

logger = get_logger("data.loading_smb")


@dataclass
class SMBData:
    corpus: SMBCorpus
    layout: TokenLayout
    builder: SMBExampleBuilder
    train: list[SMBExample] | None = None
    valid: list[SMBExample] | None = None
    test: list[SMBExample] | None = None


def _layout_for(task: str) -> TokenLayout:
    t = task.lower()
    if t == "smb":
        return TokenLayout(explicit=False)
    if t.endswith("_back"):
        return TokenLayout(explicit=True, behavior_first=False)
    return TokenLayout(explicit=True, behavior_first=True)


def load_smb_train(
    dataset: str,
    data_path: str,
    max_his_len: int,
    index_file: str,
    tasks: str,
) -> SMBData:
    task_list = tasks.split(",")
    corpus = SMBCorpus(DataFiles(data_path, dataset), index_file)
    layout = _layout_for(task_list[0])
    builder = SMBExampleBuilder(corpus, layout, max_his_len)
    train: list[SMBExample] = []
    for task in task_list:
        t = task.lower()
        if t in ("smb", "smb_explicit", "smb_explicit_back"):
            train.extend(builder.build_prefix_train_examples())
        elif t.startswith("smb_explicit_decoder"):
            augment = None if t == "smb_explicit_decoder" else int(t.split("_")[3])
            train.extend(builder.build_decoder_train_examples(augment=augment))
        elif t.startswith("smb_augment_"):
            augment = int(t.split("_")[2])
            train.extend(builder.build_decoder_train_examples(augment=augment, all_prefix=True))
        else:
            raise NotImplementedError(f"unknown SMB train task {task!r}")
    valid = builder.build_valid_examples()
    logger.info("SMB train=%d valid=%d (tasks=%s)", len(train), len(valid), tasks)
    return SMBData(corpus, layout, builder, train=train, valid=valid)


def load_smb_test(
    dataset: str,
    data_path: str,
    max_his_len: int,
    index_file: str,
    test_task: str,
) -> SMBData:
    t = test_task.lower()
    corpus = SMBCorpus(DataFiles(data_path, dataset), index_file)
    layout = _layout_for(t)
    builder = SMBExampleBuilder(corpus, layout, max_his_len)
    if t in ("smb", "smb_explicit", "smb_explicit_back"):
        test = builder.build_session_eval_examples("test")
    elif t.startswith("smb_augment_"):
        test = builder.build_session_eval_examples("test", drop_ratio=float(t.split("_")[2]))
    elif t == "smb_explicit_valid":
        test = builder.build_session_eval_examples("valid_test")
    elif t.startswith("smb_valid_augment_"):
        test = builder.build_session_eval_examples("valid_test", drop_ratio=float(t.split("_")[3]))
    elif t == "smb_drop_gt":
        test = builder.build_drop_gt_eval_examples()
    else:
        raise NotImplementedError(f"unknown SMB test task {test_task!r}")
    logger.info("SMB test=%d (task=%s)", len(test), test_task)
    return SMBData(corpus, layout, builder, test=test)
