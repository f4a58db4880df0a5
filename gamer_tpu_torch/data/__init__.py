"""The SMB data plane of the port (copies of `gamer_tpu/data`): the data
contract, the semantic-ID vocabulary, corpus and examples (SMB in `smb.py`,
single- and multi-behavior in `seq.py`, the discriminative zoo's in
`smb_dis.py`), batchers and the synthetic
generator."""

from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.vocab import SemanticVocab

__all__ = ["SemanticVocab", "DataFiles"]
