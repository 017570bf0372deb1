"""Packed-forest kernels: K1 gather descent (``ops``), K2 radix rank
(``rank``) and K3 Shapley-chain ordinals (``chain``)."""
