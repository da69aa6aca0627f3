from .fc_discriminator import FCDiscriminator

__all__ = ['FCDiscriminator']
