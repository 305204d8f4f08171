"""The benchmark's frozen generator writes the tree the port's generator
writes, byte for byte, also when its workers render it, and the same tree
for the same seed."""

import filecmp
import os

import datagen


def _files(root):
    out = []
    for dirpath, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(dirpath, n), root) for n in names]
    return sorted(out)


def test_frozen_generator_matches_the_ports(tmp_path):
    from multi_view_active_learning_tpu_torch.data import synthetic

    ours = datagen.start_tree(str(tmp_path / "ours"), 7, 3, 2, 19, 5, workers=2).wait()
    theirs = synthetic.generate_panoptic_tree(str(tmp_path / "port"), num_train_frames=3,
                                              num_val_frames=2, num_joints=19, num_cameras=5,
                                              seed=7)
    assert _files(ours) == _files(theirs)
    for rel in _files(ours):
        assert filecmp.cmp(os.path.join(ours, rel), os.path.join(theirs, rel), shallow=False), rel


def test_same_seed_gives_the_same_tree(tmp_path):
    root = datagen.start_tree(str(tmp_path / "a"), 3, 2, 1, 19, 2).wait()
    again = datagen.start_tree(str(tmp_path / "b"), 3, 2, 1, 19, 2).wait()
    other = datagen.start_tree(str(tmp_path / "c"), 4, 2, 1, 19, 2).wait()
    files = _files(root)
    assert files == _files(again) == _files(other)
    assert all(filecmp.cmp(os.path.join(root, f), os.path.join(again, f), shallow=False)
               for f in files)
    assert not filecmp.cmp(os.path.join(root, "labels.json"), os.path.join(other, "labels.json"),
                           shallow=False)
    frames = datagen.frame_records(root, "train")
    assert [f["guid"] for f in frames] == ["1710261-0", "1710261-25"]
