"""CLI: latent cluster analysis (reference ``cluster_latents.py``; JAX
``cli/cluster_latents.py``).

    python -m multimodal_isic_tpu_torch.cli.cluster_latents \
        --config_path config.yml \
        [--patch_df dataframes_latents/patch_level_latents_train_df.pkl] \
        [--k 20] [--clusterer kmeans|density|density-flat] \
        [--embed pca|neighbor] [--viz_out prefix] \
        [--knn_method exact|approx]

Two backbones, as JAX's: PCA + k-means (the default), or the
reference's pipeline, a 20-component neighbour embedding and density
clustering with a ``-1`` noise label (cuML UMAP(20) + HDBSCAN
(min_cluster_size=50, min_samples=10), ``cluster_latents.py:26-44``).
``--viz_out`` writes the 2-D neighbour embeddings (euclidean and cosine,
``cluster_latents.py:175-217``) as PNGs with their trustworthiness, and the
interactive HTML page (``:220-225``).  The purity statistics, the
10th-percentile filter and ``df_filtered.pkl``'s columns are JAX's; the
printed lines too.  Everything on the device runs on the config's
``device`` (``cli.common.resolve_device``: the card unless it says
``cpu``), in full float32; one process on one card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..analysis import cluster as C
from ..analysis import embed as E
from ..analysis import kmeans as KM
from ..analysis import pca as P
from ..analysis.bags import patient_id_from_path
from ..core.rng import generator
from .common import check_single_process, parse_config, resolve_device


def main(argv=None) -> None:
    import pandas as pd
    parser = argparse.ArgumentParser()
    parser.add_argument("--patch_df", type=str,
                        default="dataframes_latents/patch_level_latents_train_df.pkl")
    parser.add_argument("--k", type=int, default=20)
    parser.add_argument("--out", type=str, default="df_filtered.pkl")
    parser.add_argument("--clusterer",
                        choices=["kmeans", "density", "density-flat"],
                        default="kmeans",
                        help="density = hierarchical stability selection "
                             "(HDBSCAN semantics); density-flat = single-eps "
                             "DBSCAN* approximation")
    parser.add_argument("--embed", choices=["pca", "neighbor"], default="pca")
    parser.add_argument("--min_cluster_size", type=int, default=50)
    parser.add_argument("--min_samples", type=int, default=10)
    parser.add_argument("--viz_out", type=str, default="",
                        help="prefix for 2-D embedding scatter PNGs")
    parser.add_argument("--knn_method", choices=["exact", "approx"],
                        default="exact",
                        help="approx = IVF k-means bucketing + exact rerank "
                             "(analysis/ann.py) — required at the reference's "
                             "full ~2M-row patch table, cluster_latents.py:26")
    parser.add_argument("--knn_nprobe", type=int, default=None,
                        help="approx only: probed buckets per query; raise "
                             "for recall-critical runs (ann.approx_knn_graph "
                             "documents the default's recall trade)")
    parser.add_argument("--knn_buckets", type=int, default=None,
                        help="approx only: IVF bucket count (default ~sqrt N)")
    args, rest = parser.parse_known_args(argv)
    config = parse_config(rest)
    check_single_process(config)
    device = resolve_device(config["device"])
    knn_kwargs = {k: v for k, v in
                  (("nprobe", args.knn_nprobe), ("n_buckets", args.knn_buckets))
                  if v is not None}

    df = pd.read_pickle(args.patch_df)
    x = np.stack([np.asarray(v, np.float32) for v in df["patch_latent_pca"]])
    y = df["target"].values.astype(int)
    num_classes = int(config.get("num_classes", 7))

    # 20-component embedding (the reference clusters on UMAP-20)
    comps = min(20, x.shape[1])
    if args.embed == "neighbor":
        emb20 = E.neighbor_embedding(x, n_components=comps,
                                     seed=config["seed"],
                                     knn_method=args.knn_method,
                                     knn_kwargs=knn_kwargs, device=device)
    elif x.shape[1] > 20:
        xd = torch.from_numpy(x).to(device)
        emb20 = P.transform(P.fit(xd, 20), xd).cpu().numpy()
    else:
        emb20 = x
    print(f"Trustworthiness of the {args.embed} embedding: "
          f"{C.trustworthiness(x, emb20, device=device):.4f}")

    if args.clusterer in ("density", "density-flat"):
        fn = (E.hdbscan_cluster if args.clusterer == "density"
              else E.density_cluster)
        clusters = fn(emb20, min_cluster_size=args.min_cluster_size,
                      min_samples=args.min_samples,
                      knn_method=args.knn_method, knn_kwargs=knn_kwargs,
                      device=device)
        n_noise = int((clusters == -1).sum())
        print(f"Number of clusters found: "
              f"{len(np.unique(clusters[clusters >= 0]))} "
              f"(+ {n_noise} noise patches dropped, HDBSCAN -1 semantics)")
    else:
        _, clusters = KM.fit_best_of(generator(config["seed"], device), emb20,
                                     k=args.k)
        clusters = clusters.cpu().numpy()
        print(f"Number of clusters found: {len(np.unique(clusters))}")

    if args.viz_out:
        from ..utils.viz import embedding_scatter, interactive_scatter_html
        for metric in ("euclidean", "cosine"):  # cluster_latents.py:175-217
            e2 = E.neighbor_embedding(x, n_components=2, metric=metric,
                                      seed=config["seed"],
                                      knn_method=args.knn_method,
                                      knn_kwargs=knn_kwargs, device=device)
            t = C.trustworthiness(x, e2, device=device)
            path = f"{args.viz_out}_{metric}.png"
            embedding_scatter(e2, y, path,
                              title=f"{metric} neighbor embedding "
                                    f"(trustworthiness {t:.3f})")
            print(f"Wrote {path}")
            if metric == "euclidean":  # interactive plot: cluster_latents.py:220-225
                hpath = f"{args.viz_out}_interactive.html"
                hover = df["image_path"].map(
                    lambda p: p.rsplit("/", 1)[-1]).tolist()
                interactive_scatter_html(e2, clusters, hpath, hover=hover,
                                         title="patch-latent embedding "
                                               "(hover: source image)")
                print(f"Wrote {hpath}")

    patient_targets = (df.assign(pid=df["image_path"].map(patient_id_from_path))
                       .groupby("pid")["target"].agg(lambda s: s.mode()[0]).values)
    weights = C.patient_class_weights(patient_targets, num_classes)
    stats = C.cluster_purity_stats(clusters, y, num_classes, class_weights=weights)

    df = df.copy()
    df["cluster"] = clusters
    for key in ("cluster_same_count", "cluster_other_count", "cluster_prop_same",
                "cluster_ratio_same_other", "cluster_prop_same_weighted"):
        df[key] = stats[key]
    for c in range(num_classes):
        df[f"cluster_count_class_{c}"] = stats["counts_per_class"][:, c]

    keep, threshold = C.filter_low_purity_clusters(stats, percentile=10)
    print(f"10th percentile of cluster_prop_same_weighted: {threshold:.4f}")
    df_filtered = df[keep].reset_index(drop=True)
    print(f"Number of patches in training set: {len(df_filtered)} "
          f"after removing low-purity clusters")
    for c in sorted(df_filtered["target"].unique()):
        print(f"  Class {c}: {(df_filtered['target'] == c).sum()} patches")
    df_filtered.to_pickle(args.out)


if __name__ == "__main__":
    main()
