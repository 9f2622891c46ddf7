"""The device graph generator: shuffle, R-MAT, relabel, redistribute, CSR."""
