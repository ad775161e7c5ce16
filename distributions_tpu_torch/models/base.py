"""Common machinery for conjugate component models (see
distributions_tpu.models.base for the module contract each model
follows)."""

import torch


def scalar(x, dtype, device):
    """A Python number as a 0-dim tensor of `dtype` on `device`."""
    x = float(x) if dtype.is_floating_point else int(x)
    return torch.tensor(x, dtype=dtype, device=device)


def group_take(group, idx):
    """The group at index `idx` of a [K]-batched Group."""
    return type(group)(*(a[idx] for a in group))


def group_set(group, idx, sub):
    """A copy of `group` with one group's stats written into slot `idx`."""
    out = []
    for a, s in zip(group, sub):
        a = a.clone()
        a[idx] = torch.as_tensor(s, device=a.device).to(a.dtype)
        out.append(a)
    return type(group)(*out)


def group_stack(groups):
    """Stack a Python list of scalar Groups into a [K]-batched Group."""
    return type(groups[0])(*(torch.stack(leaves) for leaves in zip(*groups)))


def exact_onehot_matmul(onehot_t, flat):
    """onehot_t [K, B] (exact 0/1) @ flat [B, S] -> [K, S] in float32.

    A full-f32 matmul: each output is a plain f32 sum of the selected
    rows.  It must never run in TF32 (which keeps ~10 mantissa bits): the
    cached stat sums built from it are subtracted across sweeps.  The port
    leaves `torch.backends.cuda.matmul.allow_tf32` at its default, False.
    """
    return torch.matmul(onehot_t.to(torch.float32), flat.to(torch.float32))


# Largest [K, B] one-hot materialized in one piece; beyond this the
# contraction runs over row chunks.
ONEHOT_CHUNK_LIMIT = 1 << 28


def _onehot_t(ids, num_segments):
    k = torch.arange(num_segments, device=ids.device, dtype=ids.dtype)
    return (k[:, None] == ids[None, :]).to(torch.float32)


def segment_sum(data, segment_ids, num_segments):
    """Segment sum as an exact one-hot contraction.  Out-of-range ids
    drop.  When the [K, B] one-hot would exceed ONEHOT_CHUNK_LIMIT
    elements the rows are contracted in chunks (ceil-div, with a tail)
    and the chunk sums added in order.  Integer data is rounded back to
    its dtype."""
    data = torch.as_tensor(data)
    segment_ids = torch.as_tensor(segment_ids, device=data.device)
    out_dtype = data.dtype
    B = data.shape[0]
    flat = data.to(torch.float32).reshape(B, -1)
    if B * num_segments <= ONEHOT_CHUNK_LIMIT:
        acc = exact_onehot_matmul(_onehot_t(segment_ids, num_segments), flat)
    else:
        chunk = max(1, ONEHOT_CHUNK_LIMIT // num_segments)
        acc = torch.zeros((num_segments, flat.shape[1]),
                          dtype=torch.float32, device=data.device)
        for s in range(0, B, chunk):
            acc = acc + exact_onehot_matmul(
                _onehot_t(segment_ids[s:s + chunk], num_segments),
                flat[s:s + chunk])
    acc = acc.reshape((num_segments,) + tuple(data.shape[1:]))
    if not out_dtype.is_floating_point:
        acc = torch.round(acc)
    return acc.to(out_dtype)


def generic_sample_group(sampler_init, sampler_eval, generator, shared,
                         size):
    """Draw the group's parameters once, then `size` iid values given
    them (the `sample_group` contract of every model)."""
    params = sampler_init(generator, shared)
    return sampler_eval(generator, shared, params, (size,))
