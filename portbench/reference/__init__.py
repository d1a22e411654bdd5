"""The benchmark's plain reference: plain PyTorch, no kernel of the port and
no import of it. Each module is a frozen copy of the port's plain path at
commit 9c22c1c, named in its docstring; `lio.lio_step` and
`localization.localize_ndt` are the two pipelines the cells compare with."""
