"""Model code of the port: the language-model stack, ported family by
family (RWKV6 first; attention, Mamba and MoE come with their slices)."""
