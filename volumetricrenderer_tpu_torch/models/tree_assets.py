"""Mesh-derived tree occluder boxes, copied as data from
`volumetricrenderer_tpu/models/tree_assets.py` (generated there by
tools/bake_tree_boxes.py; do not hand-edit).

The reference's FBX tree meshes (Assets/Fbxs/Nature_Tree_*.fbx, instanced by
Assets/Prefabs/Enviornment.prefab and Tree.prefab) were parsed with
io/fbx.py, voxelized and greedily box-decomposed with models/voxelize.py
(res=20, at most 8 boxes, ~90% of the occupied voxels covered). Each entry
is (bmin, bmax, opacity) in meters for a tree standing on y=0 at the named
height; instance it with models.voxelize.transform_boxes. Kept in the
package so that scenes build without the reference checkout.
"""

# Assets/Fbxs/Nature_Tree_0_Up.fbx: 2845 verts, 3514 tris, height 6.0 m
TREE_0 = [
    ((-1.450, 2.095, -2.779), (2.610, 5.715, 1.667), 0.957),
    ((-2.030, 1.492, -5.002), (2.610, 3.905, -2.223), 0.915),
    ((-4.931, 2.095, -1.667), (-0.870, 4.508, 1.667), 0.903),
    ((-1.450, 1.492, 2.223), (3.771, 3.302, 5.002), 0.901),
    ((-0.870, 2.095, -2.779), (4.931, 5.715, 1.667), 0.886),
    ((-0.870, -0.319, -1.667), (1.450, 3.302, 0.556), 0.951),
    ((-0.870, 2.095, -2.779), (2.610, 5.715, 4.446), 0.922),
    ((-5.511, 1.492, -2.223), (-2.030, 4.508, 1.112), 0.850),
]

# Assets/Fbxs/Nature_Tree_1_Leaves.fbx: 7662 verts, 4630 tris, height 7.0 m
TREE_1 = [
    ((-6.336, 1.153, -4.462), (4.100, 5.847, 5.205), 0.941),
    ((-1.118, -0.412, -1.487), (7.081, 5.065, 5.949), 0.849),
    ((-4.845, 0.370, -7.436), (4.100, 5.847, 5.205), 0.904),
    ((-5.590, 1.153, -3.718), (4.100, 7.412, 4.462), 0.887),
]

