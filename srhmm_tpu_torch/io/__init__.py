from .dataset import UtteranceBatch, load_batch, pack_utterances
from .hmm_format import read_hmm, read_vocabulary, write_hmm
from .lists import read_list, write_list
from .perfil import read_perfil, read_perfil_list, write_perfil

__all__ = [
    "UtteranceBatch",
    "load_batch",
    "pack_utterances",
    "read_hmm",
    "read_vocabulary",
    "write_hmm",
    "read_list",
    "write_list",
    "read_perfil",
    "read_perfil_list",
    "write_perfil",
]
