"""Data parallelism across a world of processes (`torch.distributed`): the
(data, model=1) mesh, the world's set-up and the collectives that stand in
for GSPMD's."""
