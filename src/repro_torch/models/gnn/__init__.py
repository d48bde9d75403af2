"""GNN zoo (port of `repro.models.gnn`): graphcast (EPD mesh GNN), nequip
/ mace (E(3)-equivariant), dimenet (directional triplet MP) -- all on
segment-op message passing.

Submodules are imported lazily (import repro_torch.models.gnn.<name>) to
keep partial builds importable.  `ring_gather` holds the mesh's
distributed row gather and scatter, which `launch.cells`' GNN rank
program puts behind the models' `gather_fn` / `scatter_fn` hooks.
"""
