"""Traffic families: one file each, holding a family's generator (plain
data from the seed), its runner (set-up, the unit the window repeats,
what the comparison reads) and its control. A traffic mix
(`traffic/<mix>.json`) names its family; `spec.family` finds the file
by that name, so a new family is a new file here."""
