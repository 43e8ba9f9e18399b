"""Write the TF1 checkpoint fixture the port's tests and chip_smoke.py read.

  python tests/fixtures_torch/tf1_ckpt/make_fixture.py

Writes, beside this file, a ``tf.compat.v1.train.Saver`` checkpoint
(``checkpoint``, ``model.ckpt.index``, ``model.ckpt.data-00000-of-00001``)
holding the generator's and the critic's variables under the reference's
TF1 names (``sgg.convert``'s mappings) at the widths of ``SETS`` over the
smoke config, with VOCAB tokens, seeded by numpy; an int64 ``global_step``;
a float16 and a bfloat16 variable. ``arrays.npz`` holds the same arrays as
numpy reads them (the bfloat16 one widened to float32) and ``vocab.json`` a
vocab of VOCAB tokens. The ``checkpoint`` file names the prefix relative to
this directory. It needs TensorFlow and the reference package, so it runs
where both are installed, not on the card's machine and not in the tests.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

SEED = 0
# Over the smoke config; the port's tests convert the fixture with these.
SETS = ["model.hidden=8", "model.embed_dim=8", "model.attn_dim=8", "model.noise_dim=4",
        "model.critic_hidden=8", "data.feat_dim=8"]
OBJECTS, PREDICATES = 8, 4
VOCAB = 2 + OBJECTS + PREDICATES  # with the two special tokens


def reference_names(g: dict, d: dict, rng: np.random.RandomState) -> dict:
    """Seeded arrays under the reference's TF1 names for flax trees ``g``
    (the generator) and ``d`` (the critic), in the names' order."""
    rnd = lambda a: (rng.randn(*np.shape(a)) * 0.1).astype(np.float32)  # noqa: E731
    att = g["AdditiveAttention_0"]
    out = {
        "generator/embedding/weights": rnd(g["token_embedding"]),
        "generator/init_c/weights": rnd(g["init_c"]["kernel"]),
        "generator/init_c/biases": rnd(g["init_c"]["bias"]),
        "generator/init_h/weights": rnd(g["init_h"]["kernel"]),
        "generator/init_h/biases": rnd(g["init_h"]["bias"]),
        "generator/rnn/basic_lstm_cell/kernel": rnd(g["TF1LSTMCell_0"]["kernel"]),
        "generator/rnn/basic_lstm_cell/bias": rnd(g["TF1LSTMCell_0"]["bias"]),
        "generator/attention/feat_proj/weights": rnd(att["feat_proj"]["kernel"]),
        "generator/attention/state_proj/weights": rnd(att["state_proj"]["kernel"]),
        "generator/attention/state_proj/biases": rnd(att["state_proj"]["bias"]),
        "generator/attention/score/weights": rnd(att["score"]["kernel"]),
        "generator/deep_out/weights": rnd(g["deep_out"]["kernel"]),
        "generator/deep_out/biases": rnd(g["deep_out"]["bias"]),
        "generator/logits/weights": rnd(g["vocab_proj"]["kernel"]),
        "generator/logits/biases": rnd(g["vocab_proj"]["bias"]),
    }
    if d is None:
        return out
    out.update({
        "discriminator/embedding/weights": rnd(d["token_embedding"]),
        "discriminator/query_proj/weights": rnd(d["query_proj"]["kernel"]),
        "discriminator/query_proj/biases": rnd(d["query_proj"]["bias"]),
        "discriminator/key_proj/weights": rnd(d["key_proj"]["kernel"]),
        "discriminator/score/weights": rnd(d["score"]["kernel"]),
        "discriminator/head/weights": rnd(d["head"]["kernel"]),
        "discriminator/head/biases": rnd(d["head"]["bias"]),
    })
    for i in range(3):
        out[f"discriminator/trunk_{i}/weights"] = rnd(d[f"trunk_{i}"]["kernel"])
        out[f"discriminator/trunk_{i}/biases"] = rnd(d[f"trunk_{i}"]["bias"])
        out[f"discriminator/ln_{i}/gamma"] = rnd(d[f"ln_{i}"]["scale"])
        out[f"discriminator/ln_{i}/beta"] = rnd(d[f"ln_{i}"]["bias"])
    return out


def fixture_vocab():
    from sgg.data.vocab import Vocab

    return Vocab.build({f"thing{i}": 100 - i for i in range(OBJECTS)},
                       {f"rel{i}": 50 - i for i in range(PREDICATES)})


def main() -> None:
    import jax
    import tensorflow as tf

    from sgg.config import get_config
    from sgg.train.state import create_train_state

    vocab = fixture_vocab()
    assert len(vocab) == VOCAB
    cfg = get_config("smoke").override(SETS)
    cfg.model.vocab_size = VOCAB
    st = create_train_state(cfg, jax.random.key(0))
    rng = np.random.RandomState(SEED)
    arrays = reference_names(jax.tree.map(np.asarray, st.g_params),
                             jax.tree.map(np.asarray, st.d_params), rng)
    arrays["global_step"] = np.int64(123)
    arrays["extra/half"] = rng.randn(3, 5).astype(np.float16)
    bf16 = rng.randn(4, 3)
    for name in os.listdir(HERE):
        if name.startswith("model.ckpt") or name in ("checkpoint", "arrays.npz"):
            os.remove(os.path.join(HERE, name))
    tf.compat.v1.reset_default_graph()
    with tf.compat.v1.Session() as sess:
        for name, a in arrays.items():
            tf.compat.v1.get_variable(name, initializer=a)
        bf = tf.compat.v1.get_variable("extra/bf16",
                                       initializer=tf.constant(bf16, dtype=tf.bfloat16))
        sess.run(tf.compat.v1.global_variables_initializer())
        arrays["extra/bf16"] = sess.run(bf).astype(np.float32)
        tf.compat.v1.train.Saver().save(sess, os.path.join(HERE, "model.ckpt"),
                                        write_meta_graph=False)
    with open(os.path.join(HERE, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "model.ckpt"\n'
                'all_model_checkpoint_paths: "model.ckpt"\n')
    np.savez(os.path.join(HERE, "arrays.npz"), **arrays)
    vocab.save(os.path.join(HERE, "vocab.json"))
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in os.listdir(HERE))
    print(f"wrote {len(arrays)} variables, {total} bytes with this script, to {HERE}")


if __name__ == "__main__":
    main()
