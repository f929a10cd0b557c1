"""Parameter conversion: Flax parameter trees and Nadam state of the JAX
package (``from_flax``), and the reference's Keras checkpoints
(``ref_import``, with the reference loader ``refload``)."""
