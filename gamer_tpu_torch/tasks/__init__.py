"""Task registry of the port. Importing this package registers its tasks:
train_SMB_decoder, test_SMB_decoder, test_SMB_rule, train_decoder,
test_decoder, train_MB_decoder, test_MB_decoder, the item-tokenizer chain
SemEmb, RQVAE and tokenize, and the discriminative zoo's train_SMB_rec."""

from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.tasks import rqvae  # noqa: F401
from gamer_tpu_torch.tasks import semantic_emb  # noqa: F401
from gamer_tpu_torch.tasks import test_decoder  # noqa: F401
from gamer_tpu_torch.tasks import test_mb_decoder  # noqa: F401
from gamer_tpu_torch.tasks import test_smb_decoder  # noqa: F401
from gamer_tpu_torch.tasks import test_smb_rule  # noqa: F401
from gamer_tpu_torch.tasks import tokenize  # noqa: F401
from gamer_tpu_torch.tasks import train_decoder  # noqa: F401
from gamer_tpu_torch.tasks import train_mb_decoder  # noqa: F401
from gamer_tpu_torch.tasks import train_smb_decoder  # noqa: F401
from gamer_tpu_torch.tasks import train_smb_rec  # noqa: F401

task_list = dict(TASKS)

__all__ = ["TASKS", "task_list"]
