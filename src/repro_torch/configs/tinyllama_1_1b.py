"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000, head_dim=64.
"""

from repro_torch.configs.base import ArchConfig


def config(**over) -> ArchConfig:
    kw = dict(
        name="tinyllama-1.1b", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000,
    )
    kw.update(over)
    return ArchConfig(**kw)


def smoke(**over) -> ArchConfig:
    kw = dict(
        name="tinyllama-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, max_seq=64,
    )
    kw.update(over)
    return ArchConfig(**kw)
