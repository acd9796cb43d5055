from repro_torch.data.transactions import (  # noqa: F401
    gen_quest, gen_dense_tabular, gen_powerlaw_baskets, gen_bipartite,
    DATASET_REPLICAS, make_dataset,
)
