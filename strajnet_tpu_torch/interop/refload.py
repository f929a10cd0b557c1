"""Loader for the reference TF implementation (import-time interop).

Imports the reference's Keras-2 code via tf_keras and stubs the uninstalled
tensorflow_addons / waymo_open_dataset packages. The tensorflow.keras alias
stays in place for the process (tf_keras is API-compatible for everything
the parity tests and the importer use).

The reference's trajNet.py depends on ``tfa.layers.MultiHeadAttention``
(tensorflow_addons is not installable here); :func:`make_tfa_mha_class`
builds a faithful Keras-2 reimplementation of tfa's documented einsum
formulation so the reference model constructs, runs, and — critically for
the checkpoint importer — exposes the exact same weight set (per-head
query/key/value/projection kernels + projection bias) that a published
STrajNet ``.tf`` checkpoint stores.
"""

from __future__ import annotations

import sys
import types

_loaded: dict = {}


class _StubModule(types.ModuleType):
    def __getattr__(self, item):  # any attribute -> an instantiable,
        return types.SimpleNamespace  # attribute-settable dummy class


def _fake(name, leaf=False):
    m = _StubModule(name) if leaf else types.ModuleType(name)
    sys.modules[name] = m
    return m


def install_stubs():
    import tensorflow as tf
    import tf_keras

    if sys.modules.get("tensorflow.keras") is not tf_keras:
        sys.modules["tensorflow.keras"] = tf_keras
        sys.modules["tensorflow.keras.layers"] = tf_keras.layers
        tf.keras = tf_keras

    if "tensorflow_addons" not in sys.modules:
        tfa = _fake("tensorflow_addons")
        tfa.layers = types.SimpleNamespace(MultiHeadAttention=object)
        tfa.losses = types.SimpleNamespace(SigmoidFocalCrossEntropy=object)
    if "waymo_open_dataset" not in sys.modules:
        wod = _fake("waymo_open_dataset")
        protos = _fake("waymo_open_dataset.protos")
        utils = _fake("waymo_open_dataset.utils")
        wod.protos, wod.utils = protos, utils
        for leaf in ("occupancy_flow_metrics_pb2",
                     "occupancy_flow_submission_pb2", "scenario_pb2"):
            setattr(protos, leaf,
                    _fake(f"waymo_open_dataset.protos.{leaf}", leaf=True))
        for leaf in ("occupancy_flow_grids", "occupancy_flow_data",
                     "occupancy_flow_renderer", "occupancy_flow_vis"):
            setattr(utils, leaf,
                    _fake(f"waymo_open_dataset.utils.{leaf}", leaf=True))


def load_reference_module(name, ref_dir: str):
    """Imports a module file from the reference checkout with stubs."""
    key = (name, ref_dir)
    if key in _loaded:
        return _loaded[key]
    install_stubs()
    sys.path.insert(0, ref_dir)
    try:
        mod = __import__(name)
    finally:
        sys.path.remove(ref_dir)
    _loaded[key] = mod
    return mod


def set_tfa_mha(mha_class):
    """Replaces the tfa MultiHeadAttention stub with a real implementation."""
    install_stubs()
    sys.modules["tensorflow_addons"].layers.MultiHeadAttention = mha_class


def set_tfa_focal():
    """Installs a faithful TF implementation of
    tfa.losses.SigmoidFocalCrossEntropy (public tfa focal_loss.py formula:
    reduction defaults to NONE, per-sample sum over the last axis)."""
    install_stubs()
    import tensorflow as tf

    class SigmoidFocalCrossEntropy:
        def __init__(self, from_logits=False, alpha=0.25, gamma=2.0):
            self.from_logits = from_logits
            self.alpha, self.gamma = alpha, gamma

        def __call__(self, y_true, y_pred):
            y_true = tf.cast(y_true, tf.float32)
            y_pred = tf.cast(y_pred, tf.float32)
            ce = tf.keras.backend.binary_crossentropy(
                y_true, y_pred, from_logits=self.from_logits)
            p = tf.sigmoid(y_pred) if self.from_logits else y_pred
            p_t = y_true * p + (1.0 - y_true) * (1.0 - p)
            alpha_f = y_true * self.alpha + (1.0 - y_true) * (1 - self.alpha)
            modulating = tf.pow(1.0 - p_t, self.gamma)
            return tf.reduce_sum(alpha_f * modulating * ce, axis=-1)

    sys.modules["tensorflow_addons"].losses.SigmoidFocalCrossEntropy = \
        SigmoidFocalCrossEntropy


def make_tfa_mha_class():
    """tfa.layers.MultiHeadAttention (einsum form), Keras-2 — the weight
    set matches what tfa stored, so ``load_weights`` on a published
    reference checkpoint restores through this class."""
    import tensorflow as tf
    import tf_keras

    class TfaMHA(tf_keras.layers.Layer):
        def __init__(self, num_heads, head_size, output_size=None,
                     dropout=0.0, **kwargs):
            super().__init__()
            self.num_heads = num_heads
            self.head_size = head_size
            self.output_size = output_size
            self.dropout = tf_keras.layers.Dropout(dropout)

        def build(self, input_shape):
            num_query = input_shape[0][-1]
            num_key = input_shape[1][-1]
            num_value = (input_shape[2][-1] if len(input_shape) > 2
                         else num_key)
            out = (self.output_size if self.output_size is not None
                   else num_value)
            init = tf_keras.initializers.GlorotUniform()
            self.query_kernel = self.add_weight(
                "query_kernel", shape=[self.num_heads, num_query,
                                       self.head_size], initializer=init)
            self.key_kernel = self.add_weight(
                "key_kernel", shape=[self.num_heads, num_key,
                                     self.head_size], initializer=init)
            self.value_kernel = self.add_weight(
                "value_kernel", shape=[self.num_heads, num_value,
                                       self.head_size], initializer=init)
            self.projection_kernel = self.add_weight(
                "projection_kernel", shape=[self.num_heads, self.head_size,
                                            out], initializer=init)
            self.projection_bias = self.add_weight(
                "projection_bias", shape=[out],
                initializer=tf_keras.initializers.Zeros())
            self.built = True

        def call(self, inputs, mask=None, training=None):
            query = inputs[0]
            key = inputs[1]
            value = inputs[2] if len(inputs) > 2 else key
            q = tf.einsum("...NI,HIO->...NHO", query, self.query_kernel)
            k = tf.einsum("...MI,HIO->...MHO", key, self.key_kernel)
            v = tf.einsum("...MI,HIO->...MHO", value, self.value_kernel)
            q = q / tf.sqrt(tf.cast(self.head_size, q.dtype))
            logits = tf.einsum("...NHO,...MHO->...HNM", q, k)
            if mask is not None:
                m = tf.cast(mask, tf.float32)
                if len(m.shape) < len(logits.shape):
                    m = tf.expand_dims(m, -3)
                logits += -1e10 * (1.0 - m)
            attn = tf.nn.softmax(logits)
            attn = self.dropout(attn, training=training)
            out = tf.einsum("...HNM,...MHI->...NHI", attn, v)
            out = tf.einsum("...NHI,HIO->...NO", out,
                            self.projection_kernel)
            return out + self.projection_bias

    return TfaMHA


def build_reference_strajnet(cfg=None, fg_msa=True, fg=True, *,
                             ref_dir: str):
    """Constructs the reference STrajNet (modules.py:777) ready for
    ``load_weights`` — builds itself via its constructor dummy forward."""
    set_tfa_mha(make_tfa_mha_class())
    modules = load_reference_module("modules", ref_dir)
    if cfg is None:
        # the training config (reference train.py:183)
        cfg = dict(input_size=(512, 512), window_size=8, embed_dim=96,
                   depths=[2, 2, 2], num_heads=[3, 6, 12])
    return modules.STrajNet(cfg=cfg, fg_msa=fg_msa, fg=fg)
