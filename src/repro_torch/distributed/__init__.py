"""The sharded page plane on torch.distributed (DESIGN.md §9)."""
