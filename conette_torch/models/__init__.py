"""Model building blocks: layers, the ConvNeXt encoder, the decoder, the assembly."""
