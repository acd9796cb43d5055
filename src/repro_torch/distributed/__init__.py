"""Distribution layer of the port (counterpart of ``repro.distributed``):
logical-axis sharding rules, the collectives with their autograd rules,
and int8 gradient compression."""
