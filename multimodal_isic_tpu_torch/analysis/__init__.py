"""Analysis workloads: radiomics extraction (in-memory arrays), ConvMAE latent
extraction with patch moments and PCA."""
