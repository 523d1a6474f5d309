"""Feature -> label annotation matrix.

The port's copy of ``mmvae_tpu/data/annotation.py`` (reference
``annotation_t``, include/mmvae.hh:211-281): reads a two-column
``feature label`` annotation file and a feature list, and builds the
D x K 0/1 membership matrix of the labeled-mixture model
(include/models/vmfnb_mixture.hh).  Labels are numbered in the order they
first appear in the annotation file among features of the list.
"""

from __future__ import annotations

import numpy as np

from ..io.writers import read_pair_file, read_vector_file


class Annotation:
    def __init__(self, annot_file: str, feature_file: str):
        self.annot_file = annot_file
        self.feature_file = feature_file
        pairs = read_pair_file(annot_file)
        features = read_vector_file(feature_file)
        self.feature2id = {f: i for i, f in enumerate(features)}
        self.labels: list[str] = []
        label_pos: dict[str, int] = {}
        for feat, lab in pairs:
            if feat in self.feature2id and lab not in label_pos:
                label_pos[lab] = len(self.labels)
                self.labels.append(lab)
        self.label_pos = label_pos
        self._pairs = pairs
        self.D = len(self.feature2id)
        self.K = max(len(label_pos), 1)

    def matrix(self) -> np.ndarray:
        """D x K one-hot membership (reference: mmvae.hh:267-281)."""
        L = np.zeros((self.D, self.K), dtype=np.float32)
        for feat, lab in self._pairs:
            if feat in self.feature2id:
                L[self.feature2id[feat], self.label_pos[lab]] = 1.0
        return L
