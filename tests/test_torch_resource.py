"""The port's resources have no default device: a Buffer or Texture made
without a tensor, every upload from numpy and the resource cache take
``device=`` or raise TypeError; a resource made from a tensor keeps the
tensor's device."""

import numpy as np
import pytest
import torch

from zenith_tpu_torch.rhi.formats import Format
from zenith_tpu_torch.rhi.resource import Buffer, BufferDesc, ResourceCache, Texture, TextureDesc

PIX = np.ones((2, 2, 4), np.float32)
LAYERS = np.ones((6, 2, 2, 4), np.float32)

MAKERS = {
    "Buffer.from_numpy": lambda **kw: Buffer.from_numpy("b", np.zeros(3, np.float32), **kw),
    "Texture.from_numpy": lambda **kw: Texture.from_numpy("t", PIX, Format.RGBA32F, **kw),
    "Texture.from_numpy_layers": lambda **kw: Texture.from_numpy_layers(
        "t", LAYERS, Format.RGBA32F, cube=True, **kw),
    "Texture.from_numpy_3d": lambda **kw: Texture.from_numpy_3d("t", LAYERS, Format.RGBA32F, **kw),
    "Buffer(desc)": lambda **kw: Buffer(BufferDesc.storage("b", (3,)), **kw),
    "Texture(desc)": lambda **kw: Texture(TextureDesc.color("t", 2, 2), **kw),
    "ResourceCache": lambda **kw: ResourceCache(**kw),
}


@pytest.mark.parametrize("maker", list(MAKERS))
def test_no_default_device(maker):
    with pytest.raises(TypeError):
        MAKERS[maker]()
    made = MAKERS[maker](device="cpu")
    if not isinstance(made, ResourceCache):
        assert made.array.device == torch.device("cpu")


def test_resource_from_a_tensor_keeps_its_device():
    arr = torch.zeros((2, 2, 4), dtype=torch.float32, device="meta")
    assert Texture(TextureDesc.color("t", 2, 2), arr).array.device.type == "meta"
    assert Buffer(BufferDesc.storage("b", (3,)), torch.zeros(3, device="meta")).array.device.type \
        == "meta"
