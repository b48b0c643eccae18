"""Step builders of the port — `repro.dist` on one device: the LM
serving steps (`steps`). Sharding rules, compression and the
data-parallel GCN step come with the data-parallel slice (ROADMAP A5)."""
