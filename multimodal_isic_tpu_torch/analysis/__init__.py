"""Analysis workloads: radiomics extraction (in-memory arrays)."""
