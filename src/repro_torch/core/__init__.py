"""Core of the port: bitmap layout, row store, frontier scheduler and the
Eclat miner (counterparts of ``repro.core``)."""
