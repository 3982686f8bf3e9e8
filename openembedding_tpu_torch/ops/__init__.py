"""Device ops of the port: kernels (`gather`), their build (`_build`) and the
table ops built on them (`sparse`)."""
