"""Device tables beyond the plain array table: the hashed 63-bit id space
(`hash_table`)."""
