"""Manifest ETL: metadata CSVs → train/test DataFrames.

Counterpart of ``multimodal_isic_tpu/data/manifest.py`` (the reference's
``prepare_df.py``): per-class median age imputation with *train* statistics
applied to both splits, zero-filled artifact flags, 'unknown' sex and
localization, image and segmentation paths, the hard-coded bad test image
dropped, train-anchored age z-scoring and alphabetical label encoding of
dx, sex and localization (akiec=0 … vasc=6).  ``LabelEncoder`` is a numpy
twin of sklearn's, which the card's machine lacks.  pandas is imported
where a frame is read or concatenated.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

ARTIFACT_COLS = ["hair", "ruler_marks", "bubbles", "vignette", "frame", "other"]
DROPPED_TEST_IMAGE = "ISIC_0035068"
_DROP_COLS = ["dx_type", "dataset", "lesion_id", "image_id"]


class LabelEncoder:
    """Alphabetical class → index encoding (sklearn ``LabelEncoder``)."""

    def __init__(self):
        self.classes_: Optional[np.ndarray] = None

    def fit(self, values) -> "LabelEncoder":
        self.classes_ = np.unique(np.asarray(values))
        return self

    def transform(self, values) -> np.ndarray:
        values = np.asarray(values)
        idx = np.searchsorted(self.classes_, values)
        found = self.classes_[np.minimum(idx, len(self.classes_) - 1)]
        bad = (idx >= len(self.classes_)) | (found != values)
        if np.any(bad):
            raise ValueError(f"unseen labels: {np.unique(values[bad])}")
        return idx

    def fit_transform(self, values) -> np.ndarray:
        return self.fit(values).transform(values)

    def inverse_transform(self, idx) -> np.ndarray:
        return self.classes_[np.asarray(idx)]


def build_manifests(
    df_train: "pd.DataFrame",
    df_test: "pd.DataFrame",
    img_dir: str,
    seg_dir: str,
    img_dir_test: str,
    seg_dir_test: str,
) -> Tuple["pd.DataFrame", "pd.DataFrame", Dict[str, LabelEncoder]]:
    """Pure-dataframe core of the ETL (callers do the IO)."""
    df_train = df_train.copy()
    df_test = df_test.loc[:, ~df_test.columns.str.contains("^Unnamed")].copy()
    df_test = df_test[df_test["image_id"] != DROPPED_TEST_IMAGE]

    # per-class median age from TRAIN, applied to both splits
    for dx_class in df_train["dx"].unique():
        median_age = df_train.loc[df_train["dx"] == dx_class, "age"].median()
        for df in (df_train, df_test):
            sel = df["dx"] == dx_class
            df.loc[sel, "age"] = df.loc[sel, "age"].fillna(median_age)

    for column in ARTIFACT_COLS:
        if column in df_train.columns:
            df_train[column] = df_train[column].fillna(0).astype(int)
            df_test[column] = df_test[column].fillna(0).astype(int)

    for column in ("sex", "localization"):
        if column in df_train.columns:
            df_train[column] = df_train[column].fillna("unknown")
            df_test[column] = df_test[column].fillna("unknown")

    df_train["image_path"] = df_train["image_id"].apply(
        lambda x: os.path.join(img_dir, f"{x}.jpg"))
    df_train["segmentation_path"] = df_train["image_id"].apply(
        lambda x: os.path.join(seg_dir, f"{x}_segmentation.png"))
    df_test["image_path"] = df_test["image_id"].apply(
        lambda x: os.path.join(img_dir_test, f"{x}.jpg"))
    df_test["segmentation_path"] = df_test["image_id"].apply(
        lambda x: os.path.join(seg_dir_test, f"{x}_segmentation.png"))

    df_train = df_train.drop(columns=[c for c in _DROP_COLS
                                      if c in df_train.columns])
    df_test = df_test.drop(columns=[c for c in _DROP_COLS
                                    if c in df_test.columns])

    # path columns first (the reference's column order, prepare_df.py:76-80)
    cols = df_train.columns.tolist()
    cols = cols[-2:] + cols[:-2]
    df_train = df_train[cols]
    df_test = df_test[cols]

    if "age" in df_train.columns:
        age_mean = df_train["age"].mean()
        age_std = df_train["age"].std()  # pandas ddof=1, as the reference
        df_train["age_normalized"] = (df_train["age"] - age_mean) / age_std
        df_test["age_normalized"] = (df_test["age"] - age_mean) / age_std

    encoders = {"dx": LabelEncoder(), "sex": LabelEncoder(),
                "localization": LabelEncoder()}
    df_train["dx"] = encoders["dx"].fit_transform(df_train["dx"])
    df_test["dx"] = encoders["dx"].transform(df_test["dx"])
    df_train["sex_encoded"] = encoders["sex"].fit_transform(df_train["sex"])
    df_test["sex_encoded"] = encoders["sex"].transform(df_test["sex"])
    df_train["loc_encoded"] = encoders["localization"].fit_transform(
        df_train["localization"])
    df_test["loc_encoded"] = encoders["localization"].transform(
        df_test["localization"])
    return df_train, df_test, encoders


def prepare_manifests(config) -> Tuple["pd.DataFrame", "pd.DataFrame"]:
    """Full ETL: read the CSVs the config names, build the manifests and
    pickle them to ``dir.df`` / ``dir.df_test``."""
    import pandas as pd  # local: host-only dependency

    d = config["dir"]
    df_train = pd.read_csv(d["csv"])
    df_test = pd.read_csv(d["csv_test"])
    df_train, df_test, _ = build_manifests(
        df_train, df_test, d["img"], d["seg"], d["img_test"], d["seg_test"])
    if d.get("df"):
        df_train.to_pickle(d["df"])
    if d.get("df_test"):
        df_test.to_pickle(d["df_test"])
    return df_train, df_test


def merge_isic2019(
    df_train_val: "pd.DataFrame",
    df_test: "pd.DataFrame",
    isic2019_meta: "pd.DataFrame",
    isic2019_gt: "pd.DataFrame",
    img_dir_2019: str,
) -> "pd.DataFrame":
    """ISIC2019 augmentation for MAE pretraining (reference
    ``train_ae.py:41-86``): one-hot GT → dx {AK:0, BCC:1, BKL:2, DF:3,
    MEL:4, NV:5, VASC:6; SCC and UNK dropped}, deduplicated against the
    test ids, metadata columns filled with their most frequent value."""
    import pandas as pd  # local: host-only dependency

    dx_mapping = {"MEL": 4, "NV": 5, "BCC": 1, "AK": 0, "BKL": 2, "DF": 3,
                  "VASC": 6, "SCC": None, "UNK": None}
    gt = isic2019_gt.copy()
    gt["dx"] = 0
    for col, val in dx_mapping.items():
        gt.loc[gt[col] == 1, "dx"] = val
    gt = gt.drop(columns=list(dx_mapping.keys()))
    gt = gt.dropna(subset=["dx"])
    gt["dx"] = gt["dx"].astype(int)

    meta = isic2019_meta.copy()
    meta["image_path"] = meta["image"].apply(
        lambda x: os.path.join(img_dir_2019, f"{x}.jpg"))
    meta = meta.merge(gt[["image", "dx"]], on="image", how="inner")
    meta = meta[["image_path", "dx"]]

    merged = pd.concat([df_train_val, meta], ignore_index=True, sort=False)
    merged = merged.reset_index(drop=True)
    merged["image_id"] = merged["image_path"].apply(
        lambda x: os.path.basename(x).split(".")[0])
    merged = merged.drop_duplicates(subset=["image_id"],
                                    keep="first").reset_index(drop=True)

    test_ids = df_test["image_path"].apply(
        lambda x: os.path.basename(x).split(".")[0])
    merged = merged[~merged["image_id"].isin(test_ids)].reset_index(drop=True)

    fill_cols = ["segmentation_path", "age", "sex", "localization",
                 *ARTIFACT_COLS, "age_normalized", "sex_encoded",
                 "loc_encoded"]
    for column in fill_cols:
        if column in merged.columns:
            if column == "segmentation_path":
                merged[column] = merged[column].fillna("no_mask")
            else:
                merged[column] = merged[column].fillna(merged[column].mode()[0])
    return merged
