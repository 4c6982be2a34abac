"""The port's coloring engine: CSR storage, FirstFit, conflict rules, the
ragged data-driven engine, and the host-side oracle and validator."""
