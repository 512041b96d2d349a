"""Multi-device runs: the (rays, blocks) rank mesh (`mesh`), the
torchrun-style multi-host entry point (`distributed`) and the sharded
tracking, fusion, rendering and BA steps (`sharding`)."""
