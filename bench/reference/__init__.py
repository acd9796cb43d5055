"""The benchmark's plain reference: a NumPy frequent-itemset miner with its
own packing, and the count of the words the configuration's scheme has
to move (``eclat.mine``).  It imports nothing of the program."""
