"""MLP emulator network and mesh-parallel training step.

The network reproduces the reference's architecture space
(emulators/tools/mlp.py:153-190): dense layers with 'silu', 'relu', 'tanh'
or the cosmopower-style 'identity-silu' activation with learnable
(alpha, beta) per layer.

Training design: one jitted train step over a
``jax.sharding.Mesh`` — the sample batch is sharded over the 'dp' axis and
the hidden activations/weights over 'tp' (column-parallel first layer,
row-parallel output contraction); XLA inserts the psum/all-gather
collectives from the sharding annotations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import linen as nn
from jax.sharding import NamedSharding, PartitionSpec as P


class MLP(nn.Module):
    """Dense network with the reference's activation set; optional batch
    normalization before each hidden-to-hidden Dense (reference
    tools/mlp.py:119-121, 174-176)."""

    features: tuple        # hidden sizes + (output size,)
    activation: tuple      # one name per hidden layer
    batch_norm: bool = False
    dtype: str = 'float64'

    @nn.compact
    def __call__(self, x, train=False):
        nlayers = len(self.features)
        for ilayer, feat in enumerate(self.features):
            if self.batch_norm and ilayer > 0:
                x = nn.BatchNorm(use_running_average=not train, name=f'batch_{ilayer}',
                                 dtype=self.dtype, param_dtype=self.dtype, epsilon=1e-5)(x)
            x = nn.Dense(feat, name=f'layer_{ilayer}', dtype=self.dtype, param_dtype=self.dtype)(x)
            if ilayer < nlayers - 1:
                name = self.activation[ilayer]
                if name == 'identity-silu':
                    beta = self.param(f'beta_{ilayer}', nn.initializers.zeros_init(), (), self.dtype)
                    alpha = self.param(f'alpha_{ilayer}', nn.initializers.zeros_init(), (), self.dtype)
                    x = ((1.0 - beta) + beta / (1 + jnp.exp(-alpha * x))) * x
                elif name == 'silu':
                    x = x / (1 + jnp.exp(-x))
                elif name == 'relu':
                    x = jnp.maximum(x, 0.0)
                elif name == 'tanh':
                    x = jnp.tanh(x)
                else:
                    raise ValueError(f'unknown activation {name}')
        return x


def params_shardings(params, mesh):
    """Tensor-parallel shardings for MLP params: hidden kernels sharded on
    'tp' along their output (column) axis, alternating with input (row)
    axis, biases following the kernel output sharding."""
    if mesh is None or 'tp' not in mesh.axis_names:
        return jax.tree_util.tree_map(lambda x: None, params)

    def shard_layer(path, leaf):
        names = [getattr(p, 'key', getattr(p, 'name', '')) for p in path]
        layer = next((n for n in names if str(n).startswith('layer_')), None)
        if layer is None:
            return NamedSharding(mesh, P())
        ilayer = int(str(layer).split('_')[1])
        kind = names[-1]
        # alternate column/row parallel so activations stay sharded on 'tp'
        col = ilayer % 2 == 0
        if kind == 'kernel':
            spec = P(None, 'tp') if col else P('tp', None)
        else:  # bias
            spec = P('tp') if col else P()
        return NamedSharding(mesh, spec)

    return jax.tree_util.tree_map_with_path(shard_layer, params)


def init_train_state(model, rng, sample_x, learning_rate=1e-3, optimizer='adam', mesh=None):
    """Initialize (params, batch_stats, opt_state), placed according to the
    mesh. ``batch_stats`` is an empty dict when the model has no BatchNorm."""
    variables = model.init(rng, jnp.ones_like(sample_x))
    params = variables['params']
    batch_stats = variables.get('batch_stats', {})
    tx = getattr(optax, optimizer)(learning_rate)
    opt_state = tx.init(params)
    if mesh is not None:
        shardings = params_shardings(params, mesh)
        params = jax.tree_util.tree_map(jax.device_put, params, shardings)
    return params, batch_stats, opt_state, tx


def make_train_step(model, tx, mesh=None, loss='mse'):
    """Build the jitted train step. With a mesh, the batch is annotated as
    'dp'-sharded and parameters keep their 'tp' shardings, so the gradient
    all-reduce over 'dp' and the activation collectives over 'tp' are
    inserted by XLA (scaling-book recipe: annotate, let XLA place
    collectives over ICI)."""

    if loss == 'mse':
        def compute_loss(y_true, y_pred):
            return jnp.mean((y_true - y_pred) ** 2)
    else:
        compute_loss = loss

    def step(params, batch_stats, opt_state, x, y):
        if mesh is not None:
            x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P('dp', None)))
            y = jax.lax.with_sharding_constraint(y, NamedSharding(mesh, P('dp', None)))

        def loss_fn(p):
            out, mutated = model.apply({'params': p, 'batch_stats': batch_stats}, x,
                                       train=True, mutable=['batch_stats'])
            return compute_loss(y, out), mutated.get('batch_stats', batch_stats)

        (value, batch_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, batch_stats, opt_state, value

    return jax.jit(step, donate_argnums=(0, 2))


# ----------------------------------------------------------------------------
# MLP emulator engine
# ----------------------------------------------------------------------------

from .base import BaseEmulatorEngine, register_emulator_engine  # noqa: E402
from .operations import Operation, ScaleOperation, get_operation  # noqa: E402


def _make_tuple(obj, length=None):
    if np.ndim(obj) == 0:
        obj = (obj,)
        if length is not None:
            obj = obj * length
    return tuple(obj)


@register_emulator_engine
class MLPEmulatorEngine(BaseEmulatorEngine):
    """Multi-layer-perceptron engine (cosmopower/EmulateLSS heritage,
    reference tools/mlp.py): staged batch-fraction / learning-rate training
    with early stopping; the trained network is exported as an Operation
    chain ('v @ kernel + bias' + activation expressions) so serving needs no
    flax and loads reference-trained emulator files unchanged.
    """

    name = 'mlp'

    def __init__(self, *args, nhidden=(32, 32, 32), activation='silu', loss='mse', model_yoperation=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.nhidden = tuple(nhidden)
        self.loss = loss
        self.activation = _make_tuple(activation, length=len(self.nhidden))
        self.batch_norm = False
        from .base import make_list
        self.model_yoperations = [get_operation(op) for op in make_list(model_yoperation)]
        for operations in [self.xoperations, self.yoperations]:
            if len(operations) == 0 or operations[-1].name not in ['scale', 'norm', 'pca']:
                operations.append(ScaleOperation())

    def get_default_samples(self, calculator, params, engine='rqrs', niterations=int(1e4), **kwargs):
        from .samples import QMCSampler
        sampler = QMCSampler(calculator, params, engine=engine)
        return sampler.run(niterations=niterations)

    def _fit_no_operation(self, X, Y, attrs, validation_frac=0.1, optimizer='adam',
                          batch_frac=(0.1, 0.3, 1.0), epochs=1000, learning_rate=(1e-2, 1e-3, 1e-5),
                          patience=100, seed=42, mesh=None, learning_rate_scheduling=True,
                          batch_norm=False):
        self.batch_norm = bool(batch_norm)
        list_batch_frac = _make_tuple(batch_frac)
        list_epochs = _make_tuple(epochs, length=len(list_batch_frac))
        list_learning_rate = _make_tuple(learning_rate, length=len(list_batch_frac))
        list_patience = _make_tuple(patience, length=len(list_batch_frac))
        rng = np.random.RandomState(seed=seed)

        for operation in self.model_yoperations:
            operation.initialize(Y)
            Y = np.asarray(jax.vmap(operation)(jnp.asarray(Y)))

        nsamples = len(X)
        nvalidation = int(nsamples * validation_frac + 0.5)
        if nvalidation >= nsamples:
            raise ValueError('validation fraction leaves no training samples')

        model = MLP(features=self.nhidden + (Y.shape[-1],), activation=self.activation,
                    batch_norm=self.batch_norm)
        best_params = best_stats = None

        for bfrac, nepochs, lr, pat in zip(list_batch_frac, list_epochs, list_learning_rate, list_patience):
            idx_val = rng.choice(nsamples, size=nvalidation, replace=False)
            mask_train = ~np.isin(np.arange(nsamples), idx_val)
            X_train, Y_train = jnp.asarray(X[mask_train]), jnp.asarray(Y[mask_train])
            X_val, Y_val = jnp.asarray(X[idx_val]), jnp.asarray(Y[idx_val])
            ntrain = len(X_train)
            batch_size = max(int(ntrain * min(bfrac, 1.0) + 0.5), 1)
            nbatch = max(ntrain // batch_size, 1)

            if learning_rate_scheduling:
                # cosine decay over the stage (reference tools/mlp.py:7-25)
                lr = optax.cosine_decay_schedule(init_value=lr, decay_steps=max(nepochs * nbatch, 1))
            params, batch_stats, opt_state, tx = init_train_state(model, jax.random.PRNGKey(seed), X[:1],
                                                                  learning_rate=lr, optimizer=optimizer, mesh=mesh)
            if best_params is not None:
                # copies, not the retained best: the train step donates its
                # param buffers, which would delete best_params in place
                params = jax.tree_util.tree_map(jnp.array, best_params)
                batch_stats = jax.tree_util.tree_map(jnp.array, best_stats)
                opt_state = tx.init(params)
            else:
                # keep the freshly initialized network as the fallback export:
                # a run whose validation loss never lands finite (tiny smoke
                # fits, divergent schedules) must still export a servable
                # (if useless) operation chain instead of crashing on None
                best_params = jax.tree_util.tree_map(jnp.array, params)
                best_stats = jax.tree_util.tree_map(jnp.array, batch_stats)
            step = make_train_step(model, tx, mesh=mesh, loss='mse' if self.loss == 'mse' else self.loss)

            @jax.jit
            def val_loss(params, batch_stats):
                pred = model.apply({'params': params, 'batch_stats': batch_stats}, X_val)
                return jnp.mean((Y_val - pred) ** 2)

            best_loss, stall = np.inf, 0
            for epoch in range(nepochs):
                for ib in range(nbatch):
                    sl = slice(ib * batch_size, (ib + 1) * batch_size)
                    params, batch_stats, opt_state, _ = step(params, batch_stats, opt_state, X_train[sl], Y_train[sl])
                loss = float(val_loss(params, batch_stats))
                if not np.isfinite(loss):  # divergence counts as a stall
                    stall += 1
                    if stall >= pat:
                        break
                    continue
                if loss < best_loss:
                    best_loss, stall = loss, 0
                    best_params = jax.tree_util.tree_map(jnp.array, params)
                    best_stats = jax.tree_util.tree_map(jnp.array, batch_stats)
                else:
                    stall += 1
                if stall >= pat:
                    break

        self.model_operations = self._export_operations(best_params, best_stats)

    def _export_operations(self, params, batch_stats=None):
        """Flatten the trained network into the serialized Operation chain
        (reference schema: tools/mlp.py:192-216); batch-norm layers fold
        into an affine 'scale * (v - mean) + bias' operation."""
        operations = []
        nlayers = len(self.nhidden) + 1
        for ilayer in range(nlayers):
            if self.batch_norm and ilayer > 0:
                pbatch, sbatch = params[f'batch_{ilayer}'], batch_stats[f'batch_{ilayer}']
                operations.append(Operation('scale * (v - mean) + bias',
                                            locals={'scale': np.asarray(pbatch['scale'] / jnp.sqrt(sbatch['var'] + 1e-5)),
                                                    'mean': np.asarray(sbatch['mean']),
                                                    'bias': np.asarray(pbatch['bias'])}))
            player = params[f'layer_{ilayer}']
            operations.append(Operation('v @ kernel + bias',
                                        locals={name: np.asarray(player[name]) for name in ['kernel', 'bias']}))
            if ilayer < nlayers - 1:
                act = self.activation[ilayer]
                if act == 'identity-silu':
                    operations.append(Operation('((1 - beta) + beta / (1 + jnp.exp(-alpha * v))) * v',
                                                locals={'beta': np.asarray(params[f'beta_{ilayer}']),
                                                        'alpha': np.asarray(params[f'alpha_{ilayer}'])}))
                elif act == 'silu':
                    operations.append(Operation('v / (1 + jnp.exp(-v))', locals={}))
                elif act == 'relu':
                    operations.append(Operation('jnp.maximum(v, 0.)', locals={}))
                elif act == 'tanh':
                    operations.append(Operation('jnp.tanh(v)', locals={}))
        return operations

    def _predict_no_operation(self, X):
        x = X
        for operation in self.model_operations:
            x = operation(x)
        for operation in self.model_yoperations:
            x = operation.inverse(x)
        return x

    def __getstate__(self):
        state = super().__getstate__()
        for name in ['nhidden']:
            if hasattr(self, name):
                state[name] = getattr(self, name)
        for name in ['model_operations', 'model_yoperations']:
            if hasattr(self, name):
                state[name] = [operation.__getstate__() for operation in getattr(self, name)]
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        for name in ['model_operations', 'model_yoperations']:
            if name in state:
                setattr(self, name, [Operation.from_state(s) for s in state[name]])
