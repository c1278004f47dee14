"""Entries that a traffic mix drives, one file each, found by the mix's
`entry`. Each gives the mix's distinct inputs from the seed, the timed call
into the program in two halves (`program`, which submits, and `collect`,
which brings the result to the host), the control put in the program's
place, the reference's outputs and the numbers compared. For the harness's
own tests each also gives `TINY`, the tiny sizes of the mixes that drive
it, `FAULTS`, the faults of its timed path that have to make a run read
not correct (each a function of pytest's `monkeypatch`), and may give
`TINY_SETTINGS`, the tiny settings (model widths) of the configurations
of its cells."""
