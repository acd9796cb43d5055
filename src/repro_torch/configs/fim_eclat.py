"""The paper's own workload as a dry-run architecture (port of
``repro.configs.fim_eclat``): one distributed Eclat mining round (screen
+ count, count distribution over TID blocks,
``core.distributed.make_mining_round``).

Not one of the 40 assigned cells: an extra pair of cells showing the
paper's technique itself traces and shards on the production meshes.
"""

import dataclasses

from repro_torch.configs.base import ArchSpec, FIM_SHAPES


@dataclasses.dataclass(frozen=True)
class FIMConfig:
    name: str = "fim-eclat"
    scheme: str = "eclat"
    early_stop: bool = True
    block_words: int = 128


SPEC = ArchSpec(
    arch_id="fim-eclat",
    family="fim",
    source="this paper (Nguyen 2019) + Zaki KDD'97 (Eclat)",
    config_fn=lambda shape_id=None: FIMConfig(),
    smoke_config_fn=lambda: FIMConfig(name="fim-smoke", block_words=2),
    shape_ids=tuple(FIM_SHAPES),
    rules_override={},
    notes="mine_1g: 1.07B transactions, 1TB bitmap store on one pod.",
)
