"""Entries that a traffic mix drives, one file each, found by the mix's
`entry`. Each gives the mix's distinct inputs from the seed, the timed call
into the program in two halves (`program`, which submits, and `collect`,
which brings the result to the host), the control put in the program's
place, the reference's outputs and the numbers compared."""
