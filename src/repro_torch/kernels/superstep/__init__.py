"""K1 (CSR-resident superstep) and K2 (serial tail): ``csr_kernel``; K3
(gathered-tile superstep): ``kernel``."""
