"""Filesystem abstraction (counterpart:
``paddle_tpu/distributed/fleet/utils/fs.py``).

``LocalFS`` covers a local disk and a fuse-mounted store (NFS, a cloud
bucket mounted as a directory): the POSIX calls the checkpoint core needs
for crash consistency (``rename(2)`` to publish, ``fsync`` of files and
directories). ``HDFSClient`` is not ported.
"""
import os
import shutil

__all__ = ["LocalFS", "FSFileExistsError", "FSFileNotExistsError"]


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class LocalFS:
    """A local (or fuse-mounted) directory tree."""

    def ls_dir(self, path):
        """``(directories, files)`` directly under ``path``, sorted; two
        empty lists when ``path`` does not exist."""
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def is_exist(self, path):
        return os.path.exists(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst, overwrite=False):
        if not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if self.is_exist(dst):
            if not overwrite:
                raise FSFileExistsError(dst)
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path) and not exist_ok:
            raise FSFileExistsError(path)
        open(path, "a").close()

    def rename(self, src, dst):
        """Atomic rename on one filesystem, replacing ``dst``: a crash
        leaves the old entry or the new one, never a mix."""
        os.replace(src, dst)

    def fsync(self, path):
        """Flush a file's data, or a directory's entries, to stable
        storage; a filesystem that refuses to sync a directory is left
        as it is."""
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def upload(self, local_path, fs_path):
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path, dirs_exist_ok=True)
        else:
            shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)

    def list_dirs(self, path):
        return self.ls_dir(path)[0]
