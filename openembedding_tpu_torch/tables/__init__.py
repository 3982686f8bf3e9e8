"""Device tables beyond the plain array table: the hashed 63-bit id space
(`hash_table`) and the host-cached table, a hash-table cache on the card in
front of the whole table in host RAM (`host_offload`)."""
